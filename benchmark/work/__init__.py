"""Frozen work counts: model FLOPs a forward pass (one module a
configuration's ``work``) and each kernel op's bytes and operations (one
module an op of the program's ``mde`` namespace, named after it), with the
chip's published peaks in ``peaks.json``."""
