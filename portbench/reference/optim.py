"""The reference's optimizers, stepping one float32 tensor at a time.

:class:`AdamW` is AdamW as optax computes it (b1 0.9, b2 0.999, eps
1e-8, decay on every tensor), its arithmetic in float32.  The moments are
stored in the parameters' configured dtype (bfloat16), as optax keeps them
for bfloat16 parameters: that also keeps a 7B model's reference on one
card.  :class:`Adam8` is a frozen copy of the block-wise 8-bit AdamW's
arithmetic (int8 first moment, float8 e4m3 second moment, 256 values a
block along the last axis, the ratio clipped to +-10), in float32.
"""

from __future__ import annotations

import torch

BLOCK = 256
RATIO_CLIP = 10.0


def bias_corrections(b1: float, b2: float, count: int):
    return 1.0 - b1 ** count, 1.0 - b2 ** count


class AdamW:
    def __init__(self, lr: float, weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype=torch.bfloat16):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, \
            b2, eps
        self.moment_dtype = moment_dtype
        self.state = {}

    @torch.no_grad()
    def step(self, p: torch.Tensor, g: torch.Tensor, count: int) -> None:
        if id(p) not in self.state:
            self.state[id(p)] = (
                torch.zeros_like(p, dtype=self.moment_dtype),
                torch.zeros_like(p, dtype=self.moment_dtype))
        m, v = self.state[id(p)]
        mf = m.float() * self.b1 + g * (1 - self.b1)
        vf = v.float() * self.b2 + g * g * (1 - self.b2)
        c1, c2 = bias_corrections(self.b1, self.b2, count)
        u = (mf / c1) / (torch.sqrt(vf / c2) + self.eps) + self.wd * p
        p.add_(u, alpha=-self.lr)
        m.copy_(mf)
        v.copy_(vf)

    def first_moment(self, p: torch.Tensor) -> torch.Tensor:
        """The stored first moment of ``p``, in float32."""
        return self.state[id(p)][0].float()


def _blocks(x: torch.Tensor) -> torch.Tensor:
    last = x.shape[-1]
    b = BLOCK if last % BLOCK == 0 else last
    return x.reshape(*x.shape[:-1], last // b, b)


def _quant(rows: torch.Tensor, top: float, dtype):
    scale = rows.abs().amax(-1, keepdim=True) / top
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = rows / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(q), -127, 127)
    return q.to(dtype), scale


class Adam8:
    def __init__(self, lr: float, weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, \
            b2, eps
        self.state = {}

    @torch.no_grad()
    def step(self, p: torch.Tensor, g: torch.Tensor, count: int) -> None:
        gb = _blocks(g.float())
        if id(p) not in self.state:
            z = torch.zeros_like(gb)
            self.state[id(p)] = (_quant(z, 127.0, torch.int8),
                             _quant(z, 448.0, torch.float8_e4m3fn))
        (mq, ms), (vq, vs) = self.state[id(p)]
        mf = mq.float() * ms * self.b1 + gb * (1 - self.b1)
        vf = vq.float() * vs * self.b2 + gb * (1 - self.b2) * gb
        c1, c2 = bias_corrections(self.b1, self.b2, count)
        ratio = torch.clamp((mf / c1) / (torch.sqrt(vf / c2) + self.eps),
                            -RATIO_CLIP, RATIO_CLIP)
        upd = (ratio + _blocks(p) * self.wd) * -self.lr
        p.add_(upd.reshape(p.shape))
        self.state[id(p)] = (_quant(mf, 127.0, torch.int8),
                         _quant(vf, 448.0, torch.float8_e4m3fn))

    def first_moment(self, p: torch.Tensor) -> torch.Tensor:
        """The stored first moment of ``p``, dequantized to float32."""
        mq, ms = self.state[id(p)][0]
        return (mq.float() * ms).reshape(p.shape)


def make(name: str, lr: float, weight_decay: float):
    if name == "adamw":
        return AdamW(lr, weight_decay)
    if name == "adamw8bit":
        return Adam8(lr, weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")
