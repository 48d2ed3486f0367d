"""Plain PyTorch layers of the reference models, on NHWC tensors.

Every layer computes through a :class:`Numerics`: ``"f32"`` is the
reference (float32 throughout; TF32 must be off, which :func:`strict_f32`
does), ``"fp8"`` is the control, one precision below the bfloat16 the
configurations state: activations in bfloat16 and both operands of every
matrix product and convolution rounded to float8 e4m3 with a per-tensor
scale (the rounding passes the gradient straight through).

Random masks are drawn from a ``torch.Generator`` in the order, shapes
and comparison the program under test draws them, so that one seed gives
both sides the same masks. BatchNorm updates its running statistics once
a step (:func:`start_step`), however often a checkpointed block runs
again in the backward pass.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


class Numerics:
    """``mode`` "f32" (the reference) or "fp8" (the control)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode
        self.act_dtype = torch.float32 if mode == "f32" else torch.bfloat16

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A product's operand in the activation dtype (in fp8 mode,
        rounded to e4m3 under a per-tensor scale)."""
        t = t.to(self.act_dtype)
        if self.mode == "f32":
            return t
        amax = t.detach().abs().amax().float().clamp_min(1e-30)
        scale = E4M3_MAX / amax
        q = ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
        return t + (q - t).detach()


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matrix products and cuDNN convolutions while active."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """True with probability 1 - rate: a uniform draw on the generator's
    device compared with the rate."""
    gen_device = generator.device if generator is not None else device
    return (torch.rand(shape, generator=generator, device=gen_device) >= rate).to(device)


def apply_keep(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Kept elements divided by the keep probability, the rest zero;
    ``keep`` broadcasts from the leading dimensions."""
    if keep is None:
        return x
    keep = keep.reshape(tuple(keep.shape) + (1,) * (x.dim() - keep.dim()))
    keep_prob = torch.tensor(1.0 - rate, dtype=torch.float32).to(x.dtype).to(x.device)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        return apply_keep(x, keep_mask(x.shape, self.rate, generator, x.device), self.rate)


class Linear(nn.Module):
    def __init__(self, num: Numerics, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.num.operand(x) @ self.num.operand(self.weight).t()
        return y if self.bias is None else y + self.bias.to(y.dtype)


def conv2d(num: Numerics, x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1, groups: int = 1,
           pad: int = 0) -> torch.Tensor:
    """Convolution of NHWC x with an OIHW weight after ``pad`` pixels of
    replicated border on each side."""
    xc = num.operand(x).permute(0, 3, 1, 2)
    if pad:
        xc = F.pad(xc, (pad, pad, pad, pad), mode="replicate")
    y = F.conv2d(xc, num.operand(weight), None if bias is None else bias.to(xc.dtype),
                 stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """k x k convolution, replicate-padded to keep the size unless
    ``stride`` > 1 (a patchify convolution)."""

    def __init__(self, num: Numerics, cin: int, cout: int, k: int, bias: bool = False,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        self.num, self.stride, self.groups = num, stride, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = 0 if self.stride > 1 else self.weight.shape[-1] // 2
        return conv2d(self.num, x, self.weight, self.bias, self.stride, self.groups, pad)


class LayerNorm(nn.Module):
    def __init__(self, num: Numerics, dim: int, eps: float = 1e-5):
        super().__init__()
        self.num, self.eps = num, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(self.num.act_dtype)


class BatchNorm(nn.Module):
    """Batch statistics over N, H, W in training (the biased variance),
    running ones in eval; the running averages move once a step by
    ``momentum``."""

    def __init__(self, num: Numerics, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.num, self.eps, self.momentum = num, eps, momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.updated = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=dims)
            var = x32.var(dim=dims, unbiased=False)
            if not self.updated:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(m * mean.detach())
                    self.running_var.mul_(1 - m).add_(m * var.detach())
                self.updated = True
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.num.act_dtype)


def start_step(model: nn.Module) -> None:
    """Let every BatchNorm update its running statistics once more."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.updated = False


class ConvBN(nn.Module):
    """Replicate-padded bias-free conv -> BatchNorm -> GELU (or none)."""

    def __init__(self, num: Numerics, cin: int, cout: int, k: int = 3, act: bool = True,
                 momentum: float = 0.1):
        super().__init__()
        self.act = act
        self.conv = Conv(num, cin, cout, k)
        self.bn = BatchNorm(num, cout, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return gelu(x) if self.act else x


class Upsample(nn.Module):
    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample(x, self.scale)


def resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Align-corners bilinear resize of NHWC x, computed in f32."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[1:3]) == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=size, mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    return resize(x, (x.shape[1] * scale, x.shape[2] * scale))


def pad_edge(x: torch.Tensor, bottom: int, right: int) -> torch.Tensor:
    """Repeat the last row ``bottom`` times and the last column ``right``
    times."""
    if bottom == 0 and right == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (0, right, 0, bottom), mode="replicate")
    return y.permute(0, 2, 3, 1)


def pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    return pad_edge(x, (-x.shape[1]) % multiple, (-x.shape[2]) % multiple)


def windows(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/r * W/r, r*r, C), image-major, rows first."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, r * r, c)


def unwindows(x: torch.Tensor, r: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(-1, h // r, w // r, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def shift(x: torch.Tensor, s: int) -> torch.Tensor:
    return x if s == 0 else torch.roll(x, (-s, -s), dims=(1, 2))


def unshift(x: torch.Tensor, s: int) -> torch.Tensor:
    return x if s == 0 else torch.roll(x, (s, s), dims=(1, 2))


def shift_mask(h: int, w: int, r: int, s: int, device) -> torch.Tensor:
    """(nW, r*r, r*r) additive mask, -100 between tokens of different
    regions of the cyclically shifted map (Swin's SW-MSA)."""
    def region(n: int) -> torch.Tensor:
        i = torch.arange(n, device=device)
        return (i >= n - r).long() + (i >= n - s).long()

    lab = region(h)[:, None] * 3 + region(w)[None, :]
    lab = windows(lab[None, :, :, None], r)[..., 0]
    diff = lab[:, :, None] - lab[:, None, :]
    return torch.where(diff != 0, -100.0, 0.0).float()


def relative_index(r: int, device) -> torch.Tensor:
    """(r*r, r*r) index into a (2r-1)^2 relative-position table."""
    coords = torch.stack(torch.meshgrid(torch.arange(r), torch.arange(r), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (r - 1)
    return (rel[..., 0] * (2 * r - 1) + rel[..., 1]).to(device)


def attend(num: Numerics, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           heads: int, scale: float, add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale + add) v over (BW, N, C) windows. ``add``:
    (heads, N, N) for every window, or (G, heads, N, N) where window w
    takes ``add[w % G]``."""
    bw, n, c = q.shape
    qh, kh, vh = (t.reshape(bw, n, heads, c // heads).transpose(1, 2) for t in (q, k, v))
    logits = (num.operand(qh) @ num.operand(kh).transpose(-1, -2)).float() * scale
    if add is not None:
        g = add.shape[0] if add.dim() == 4 else 1
        logits = (logits.reshape(bw // g, g, heads, n, n)
                  + add.reshape(g, heads, n, n)).reshape(bw, heads, n, n)
    p = logits.softmax(dim=-1).to(num.act_dtype)
    out = num.operand(p) @ num.operand(vh)
    return out.transpose(1, 2).reshape(bw, n, c)
