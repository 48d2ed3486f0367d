"""The ODA family: a Swin-L/384 window-12 encoder and its decoders."""
