"""Dynamic int8 post-training quantization of the serving CNNs (the JAX
package's `ops/quant.py`).

`quantize_convs` swaps each eligible `nn.Conv2d` of a model for an
`Int8Conv2d` with the same state-dict keys; the model's definition is not
touched. Eligibility is JAX's: a contraction kh * kw * C_in of at least
`min_contraction` (64), at least `min_features` (32) output channels and
one group, any stride, padding or kernel dilation. The 1-channel stems,
the narrow heads and MobileNet's depthwise convs stay float convs.

The forward is JAX's `int8_conv_interceptor`:

- per output channel, the weight scale max|w| / 127 (at least 1e-12) and
  w_q = round(w / s_w), from the float32 weight;
- one dynamic activation scale per tensor, max|x| / 127 (at least 1e-12),
  over the whole batch, so a frame's output depends on its batch;
  x_q = clip(round(x / s_x), -127, 127), round half to even;
- int8 x int8 with an exact int32 sum (`int8_conv`);
- the epilogue y * (s_x * s_w) + bias in float32, cast back to the input's
  type. The weight, its scales and the bias stay float32 whatever type the
  model is moved to, as the JAX module keeps its float32 parameters.

`rounding` picks which of the JAX package's two programs the arithmetic
follows, as they round apart: "compiled", its jitted serving pipelines,
where XLA divides by 127 as a multiply by the float32 reciprocal and
contracts the epilogue into one fused multiply-add (`core.numerics`); and
"eager", its `evaluate` command, which calls the model op by op: a true
division and an epilogue rounded twice. The scales stay tensors on the
model's device: no value is read back to the host.

On the card the int32 product is one `torch._int_mm` (cuBLASLt s8 x s8 ->
s32) over an im2col of the padded NHWC input: the JAX package left this
conv to XLA, not to a Pallas kernel, so there is no TPU kernel here to
write by hand. `_int_mm` takes more than 16 rows and depths and widths that
are multiples of 8: the rows, the depth K = kh * kw * C_in and the width
C_out are padded with zeros, which leaves the sum exact. On the CPU
`int8_conv_plain` computes it: `F.conv2d` in float64 on the int8 values,
exact, since |sum| <= 127**2 * 9065 (RTPoseVGG's 7x7x185, the widest
contraction) is far below 2**53. A CUDA tensor that `_int_mm` refuses
raises; nothing falls back to a float conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from popnet_tpu_torch.core.numerics import div_const, fma_f32

__all__ = ["Int8Conv2d", "eligible", "epilogue", "gemm", "im2col", "int8_conv", "int8_conv_plain",
           "quantize_activation", "quantize_convs", "quantize_weight", "weight_matrix"]

ROUNDINGS = ("compiled", "eager")
_INT_MM_MAX = 2**31 - 1     # elements of one _int_mm operand (32-bit offsets)


def _div127(t: torch.Tensor, rounding: str) -> torch.Tensor:
    if rounding == "compiled":
        return div_const(t, 127)
    # a true division on either device: a tensor divisor on t's device (the
    # card multiplies by the reciprocal of a Python number or of a CPU scalar)
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def epilogue(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
             rounding: str) -> torch.Tensor:
    """y * scale + bias in float32, y an int32 (..., C_out), scale (C_out,)."""
    yf = y.float()
    if bias is None:
        return yf * scale
    if rounding == "eager":
        return yf * scale + bias
    if yf.device.type == "cuda":
        return torch.addcmul(bias, yf, scale)       # one fused multiply-add a value on the card
    return fma_f32(yf, scale, bias)


def quantize_weight(w: torch.Tensor, rounding: str = "compiled"):
    """(C_out, C_in, kh, kw) float32 -> (int8 weight, float32 (C_out,) scales)."""
    w32 = w.detach().float()
    s_w = torch.clamp_min(_div127(w32.abs().amax(dim=(1, 2, 3)), rounding), 1e-12)
    return torch.round(w32 / s_w[:, None, None, None]).to(torch.int8), s_w


def quantize_activation(x: torch.Tensor, rounding: str = "compiled"):
    """x (any float type) -> (int8 x_q, float32 0-d scale s_x) over the whole tensor."""
    # max|x| in x's own type is exact, and so is its cast to float32
    s_x = torch.clamp_min(_div127(torch.linalg.vector_norm(x, float("inf")).float(), rounding),
                          1e-12)
    q = torch.div(x.float(), s_x).round_().clamp_(-127.0, 127.0)
    return q.to(torch.int8), s_x


def int8_conv_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride, padding,
                    dilation) -> torch.Tensor:
    """The exact int32 conv of int8 NCHW x_q and int8 OIHW w_q: F.conv2d in
    float64, whose sums of at most 127**2 * 9065 are exact."""
    y = F.conv2d(x_q.double(), w_q.double(), None, stride, padding, dilation)
    return y.to(torch.int32)


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def weight_matrix(w_q: torch.Tensor) -> torch.Tensor:
    """int8 OIHW (C_out, C_in, kh, kw) -> the (N, K) int8 matrix of
    `int8_conv`'s product, K = kh * kw * C_in in (kh, kw, C_in) order, both
    padded with zeros to multiples of 8."""
    O = w_q.shape[0]
    m = w_q.permute(0, 2, 3, 1).reshape(O, -1)
    K = m.shape[1]
    return F.pad(m, (0, _ceil8(K) - K, 0, _ceil8(O) - O)).contiguous()


def im2col(x_q: torch.Tensor, kh: int, kw: int, stride, padding, dilation, Kp: int):
    """int8 NCHW (any strides) -> its (max(N * Ho * Wo, 17), Kp) im2col
    matrix in (kh, kw, C) column order, zero-padded from K = kh * kw * C to
    Kp columns and to the 17 rows `_int_mm` takes at least; a 1x1 conv at
    stride 1 without padding over 8k channels is x_q in NHWC as it is."""
    N, C, H, W = x_q.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0) and C == Kp and N * H * W > 16:
        return x_q.permute(0, 2, 3, 1).reshape(N * H * W, C), Ho, Wo
    xp = x_q.new_zeros(N, H + 2 * ph, W + 2 * pw, C)
    xp[:, ph:ph + H, pw:pw + W] = x_q.permute(0, 2, 3, 1)
    K = kh * kw * C
    cols = x_q.new_empty(max(N * Ho * Wo, 17), Kp)      # _int_mm takes more than 16 rows
    cols[:, K:].zero_()
    cols[N * Ho * Wo:].zero_()
    sN, sH, sW, _ = xp.stride()
    taps = xp.as_strided((N, Ho, Wo, kh, kw, C), (sN, sh * sH, sw * sW, dh * sH, dw * sW, 1))
    cols[:N * Ho * Wo, :K].view(N, Ho, Wo, kh, kw, C).copy_(taps)
    return cols, Ho, Wo


def int8_conv(x_q: torch.Tensor, w_mat: torch.Tensor, w_q: torch.Tensor, stride, padding,
              dilation) -> torch.Tensor:
    """The exact int32 conv of int8 NCHW x_q and int8 OIHW w_q, as an
    (N, Ho, Wo, C_out) int32 tensor (NHWC). w_mat is `weight_matrix(w_q)`
    on x_q's device. On the card: an im2col and one `torch._int_mm` (in
    row blocks where an operand passes 2**31 - 1 elements), counted in its
    `launches` attribute; on the CPU: `int8_conv_plain`. Raises on any other device."""
    O, _, kh, kw = w_q.shape
    if x_q.device.type == "cpu":
        return int8_conv_plain(x_q, w_q, stride, padding, dilation).permute(0, 2, 3, 1)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for {x_q.device}")
    if x_q.dtype != torch.int8 or w_mat.dtype != torch.int8 or w_mat.device != x_q.device:
        raise ValueError("int8_conv: int8 operands on one card expected")
    N = x_q.shape[0]
    cols, Ho, Wo = im2col(x_q, kh, kw, stride, padding, dilation, w_mat.shape[1])
    y = gemm(cols, w_mat)
    int8_conv.launches += 1
    return y[:N * Ho * Wo, :O].unflatten(0, (N, Ho, Wo))


int8_conv.launches = 0      # int8 convs run on the card since it was last set to 0


def gemm(cols: torch.Tensor, w_mat: torch.Tensor) -> torch.Tensor:
    """cols (R, Kp) int8 @ w_mat (Np, Kp) int8 transposed -> (R, Np) int32
    on the card: `torch._int_mm`, in row blocks where an operand passes
    2**31 - 1 elements."""
    R, Np = cols.shape[0], w_mat.shape[0]
    blocks = -(-R * max(cols.shape[1], Np) // _INT_MM_MAX)
    if blocks == 1:
        return torch._int_mm(cols, w_mat.t())
    y = torch.empty(R, Np, dtype=torch.int32, device=cols.device)
    step = -(-R // blocks)
    for r0 in range(0, R, step):
        torch._int_mm(cols[r0:r0 + step], w_mat.t(), out=y[r0:r0 + step])
    return y


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


class Int8Conv2d(nn.Module):
    """An eligible `nn.Conv2d` run as a dynamic-int8 conv (the module
    docstring). `weight` and `bias` keep the conv's state-dict keys, in
    float32; the int8 weight, its (N, K) GEMM matrix and the scales are
    buffers left out of the state dict, computed once here from the
    float32 weight, so the module is for inference. Its output is NCHW
    with channels-last strides, in the input's type."""

    def __init__(self, conv: nn.Conv2d, rounding: str = "compiled"):
        super().__init__()
        if rounding not in ROUNDINGS:
            raise ValueError(f"unknown rounding {rounding!r}")
        if conv.groups != 1 or conv.padding_mode != "zeros" or isinstance(conv.padding, str):
            raise ValueError("Int8Conv2d takes an ungrouped conv with numeric zero padding")
        self.rounding = rounding
        self.stride, self.padding = _pair(conv.stride), _pair(conv.padding)
        self.dilation = _pair(conv.dilation)
        self.weight = nn.Parameter(conv.weight.detach().float().clone(), requires_grad=False)
        self.bias = (None if conv.bias is None else
                     nn.Parameter(conv.bias.detach().float().clone(), requires_grad=False))
        w_q, s_w = quantize_weight(self.weight, rounding)
        self.register_buffer("weight_q", w_q, persistent=False)
        self.register_buffer("weight_mat", weight_matrix(w_q), persistent=False)
        self.register_buffer("weight_scale", s_w, persistent=False)

    def _apply(self, fn, recurse=True):
        # moves between devices, never casts: the float32 tensors stay float32
        device = fn(torch.zeros((), device=self.weight.device)).device
        return super()._apply(lambda t: t.to(device), recurse)

    def extra_repr(self) -> str:
        O, C, kh, kw = self.weight.shape
        return (f"{C}, {O}, kernel_size=({kh}, {kw}), stride={self.stride}, "
                f"padding={self.padding}, dilation={self.dilation}, rounding={self.rounding}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q, s_x = quantize_activation(x, self.rounding)
        y = int8_conv(x_q, self.weight_mat, self.weight_q, self.stride, self.padding,
                      self.dilation)
        out = epilogue(y, s_x * self.weight_scale, self.bias, self.rounding)
        return out.to(x.dtype).permute(0, 3, 1, 2)


def eligible(conv: nn.Module, min_contraction: int = 64, min_features: int = 32) -> bool:
    """JAX's `int8_conv_interceptor` test of one conv."""
    if not isinstance(conv, nn.Conv2d) or conv.groups != 1:
        return False
    kh, kw = conv.kernel_size
    return kh * kw * conv.in_channels >= min_contraction and conv.out_channels >= min_features


def quantize_convs(model: nn.Module, min_contraction: int = 64, min_features: int = 32,
                   rounding: str = "compiled") -> int:
    """Swap every eligible conv of `model` for an `Int8Conv2d` in place;
    returns how many were swapped. Quantize a float32 model: the weight
    scales are taken from the weights as they are."""
    swapped = 0
    for name, m in list(model.named_modules()):
        if eligible(m, min_contraction, min_features):
            parent, _, attr = name.rpartition(".")
            setattr(model.get_submodule(parent), attr, Int8Conv2d(m, rounding))
            swapped += 1
    return swapped
