"""The arithmetic of the plain reference, and its lower-precision controls.

Every contraction of the reference (linear, convolution, the two products
of attention) goes through one ``Arith``. ``Arith("fp32")`` is the
reference: float32 operands, float32 accumulation, TF32 off (``fp32_mode``).
The other kinds are the controls that the comparison has to fail: the same
function with every operand of every contraction rounded first, and the
result rounded after, as a kernel of that precision would give it:

- ``bf16``: operands and results rounded to bfloat16 (a bf16 GEMM that
  accumulates in fp32 and writes bf16);
- ``fp8``: operands scaled per tensor into float8 e4m3 and rounded there,
  results rounded to bfloat16 (an fp8 GEMM that writes bf16).

Norms, softmax and the sampler's arithmetic stay fp32 in every kind, as they
do in the program. Rounding passes gradients straight through, so a
training control differentiates the rounded function.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

KINDS = ("fp32", "bf16", "fp8")
_E4M3_MAX = 448.0


def _straight_through(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return y if not x.requires_grad else x + (y - x).detach()


class Arith:
    """The precision that the reference's contractions run in."""

    def __init__(self, kind: str = "fp32"):
        if kind not in KINDS:
            raise ValueError(f"unknown arithmetic {kind!r}; one of {KINDS}")
        self.kind = kind

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "fp32":
            return x
        if self.kind == "bf16":
            return _straight_through(x, x.detach().to(torch.bfloat16).float())
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = _E4M3_MAX / amax
        y = (x.detach() * scale).clamp(-_E4M3_MAX, _E4M3_MAX).to(torch.float8_e4m3fn).float() / scale
        return _straight_through(x, y)

    def result(self, y: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return y
        return _straight_through(y, y.detach().to(torch.bfloat16).float())

    def linear(self, x, weight, bias=None):
        y = F.linear(self.operand(x), self.operand(weight))
        y = self.result(y)
        return y if bias is None else y + bias.float()

    def conv(self, fn, x, weight, bias=None, **kw):
        y = self.result(fn(self.operand(x), self.operand(weight), None, **kw))
        if bias is None:
            return y
        return y + bias.float().reshape((1, -1) + (1,) * (y.ndim - 2))

    def matmul(self, a, b):
        return self.result(torch.matmul(self.operand(a), self.operand(b)))

    def attention(self, q, k, v, mask=None, rows: int = 4):
        """``softmax(q k^T / sqrt(d) + mask) v`` over ``[B, H, N, D]``, the
        softmax in fp32, ``rows`` batch rows at a time so that the fp32
        logits of long sequences fit."""
        scale = 1.0 / math.sqrt(q.shape[-1])
        outs = []
        for i in range(0, q.shape[0], rows):
            s = self.matmul(q[i : i + rows], k[i : i + rows].transpose(-1, -2)) * scale
            if mask is not None:
                s = s + mask[i : i + rows] if mask.shape[0] > 1 else s + mask
            outs.append(self.matmul(torch.softmax(s, dim=-1), v[i : i + rows]))
        return torch.cat(outs)


@contextlib.contextmanager
def fp32_mode():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def set_arith(model: torch.nn.Module, ar: Arith) -> torch.nn.Module:
    """Give every module of ``model`` the arithmetic ``ar``."""
    for m in model.modules():
        m.ar = ar
    return model
