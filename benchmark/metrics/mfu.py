"""The whole step's share of the card's peak: the model FLOPs of the
window's images (the configuration's work module, a forward pass an
image; a train step counts three, recompute not counted) over the
window's seconds and the published bf16 peak, in %."""

from benchmark import harness


def read(name, rec):
    w = rec.window
    if not w.get("images"):
        return None
    work = harness.load_module("work", rec.config["work"])
    flops = work.forward_flops(rec.config["model"], rec.traffic["height"], rec.traffic["width"],
                               rec.config["max_depth"])
    per_image = flops * (3 if rec.traffic["mode"] == "train" else 1)
    peak = harness.load_json("work", "peaks")["bf16_flops_per_s"]
    return 100.0 * per_image * w["images"] / w["seconds"] / peak
