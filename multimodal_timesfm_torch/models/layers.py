"""Core building blocks: dense, norms, the residual MLP, causal attention, the stack.

Counterpart of ``multimodal_timesfm_tpu/models/layers.py``. The numeric rules
are the JAX package's: GEMMs accumulate in fp32 and cast once to the input
dtype; the low-precision norms accumulate their moments in fp32, keep the
(..., D) intermediates in the input dtype and apply the learned gain in fp32
with one final cast. Padding masks are bool, True = padded.

Weights are stored as ``nn.Linear`` does, (out, in); the JAX package stores
(in, out) (``models/bridge.py`` converts).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_timesfm_torch.ops.attention import (
    flash_causal_attention,
    fused_causal_attention,
    needs_flash,
    plain_causal_attention,
    supports_fused,
    takes_kernels,
    trials_first,
)
from multimodal_timesfm_torch.ops.qkv_attention import (
    fused_qkv_causal_attention,
    split_heads,
    supports_qkv_fused,
)
from multimodal_timesfm_torch.parallel.collectives import (
    ModelAxis,
    copy_to_model,
    reduce_from_model,
    scatter_to_model,
)

# 1/ln(2): softplus(0) * _R_SOFTPLUS_0 == 1, so a zero per-dim scale is 1/sqrt(D).
_R_SOFTPLUS_0 = 1.442695041


def xavier_uniform(shape: tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """Xavier-uniform init of an (out, in) weight, from ``generator``."""
    fan_out, fan_in = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices with fp32 accumulation and an fp32 result.

    On CUDA one cuBLAS bf16 GEMM with an fp32 output (``aten::mm.dtype``); on
    the CPU, where that overload has no kernel, the same products in fp32 (a
    bf16 x bf16 product is exact in fp32, so only the summation order differs).
    """
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`_mm32` over a leading batch axis: (T, M, K) @ (T, K, N) in fp32, one
    batched GEMM (``aten::bmm.dtype`` on CUDA, the fp32 upcast on the CPU)."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _DenseBf16(torch.autograd.Function):
    """:func:`gemm` when x and the weight are both bf16, with JAX's VJP of it.

    ``aten::mm.dtype`` has no derivative, so the backward is written out: the
    cotangent, as bf16, times the bf16 weight (dx) and the bf16 input (dW),
    each accumulated in fp32 and cast once to its operand's dtype; the bias
    gradient is the fp32 sum of the cotangent. The result is cast to
    ``out_dtype``: x's dtype for :func:`dense`, fp32 for a row-parallel block
    whose partial sums are reduced before the cast (a bf16 cotangent of
    either is exact as bf16).

    A (T, out, in) weight with x (T, ..., in) and a (T, out) bias is T
    independent GEMMs run as one batched GEMM: the form the vmap rule gives a
    trial axis whose weights are per trial (a baseline sweep). Under
    ``torch.func.vmap`` (``aten::mm.dtype`` has no batching rule) a shared
    weight takes the trial axis into its rows: one GEMM for all trials.
    """

    @staticmethod
    def forward(
        x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, out_dtype: torch.dtype
    ) -> torch.Tensor:
        if weight.dim() == 3:
            x3 = x.reshape(x.shape[0], -1, x.shape[-1])
            y = _bmm32(x3, weight.transpose(1, 2))
            if bias is not None:
                y = y + bias.float()[:, None, :]
            return y.to(out_dtype).reshape(*x.shape[:-1], weight.shape[1])
        y = _mm32(x.reshape(-1, x.shape[-1]), weight.t())
        if bias is not None:
            y = y + bias.float()
        return y.to(out_dtype).reshape(*x.shape[:-1], weight.shape[0])

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        x, weight, bias, _ = inputs
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = None if bias is None else bias.dtype

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight = ctx.saved_tensors
        dx = dw = db = None
        g = g.to(weight.dtype)
        if weight.dim() == 3:
            x3 = x.reshape(x.shape[0], -1, x.shape[-1])
            g3 = g.reshape(g.shape[0], -1, g.shape[-1])
            if ctx.needs_input_grad[0]:
                dx = _bmm32(g3, weight).to(x.dtype).reshape(x.shape)
            if ctx.needs_input_grad[1]:
                dw = _bmm32(g3.transpose(1, 2), x3).to(weight.dtype)
            if ctx.needs_input_grad[2]:
                db = g3.float().sum(dim=1).to(ctx.bias_dtype)
            return dx, dw, db, None
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[0]:
            dx = _mm32(g2, weight).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = _mm32(g2.t(), x2).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = g2.float().sum(dim=0).to(ctx.bias_dtype)
        return dx, dw, db, None

    @staticmethod
    def vmap(info, in_dims, x, weight, bias, out_dtype):
        x_dim, w_dim, b_dim, _ = in_dims
        trials = info.batch_size
        x = trials_first(x, x_dim, trials)
        if w_dim is None and b_dim is None:
            return _DenseBf16.apply(x, weight, bias, out_dtype), 0
        weight = trials_first(weight, w_dim, trials)
        if bias is not None:
            bias = trials_first(bias, b_dim, trials)
        return _DenseBf16.apply(x, weight, bias, out_dtype), 0


def gemm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, out_dtype: torch.dtype
) -> torch.Tensor:
    """``x @ weight.T + bias`` accumulated in fp32, bias added in fp32, one cast to ``out_dtype``.

    x and weight both bf16 (a bf16-stored weight under bf16 compute): a bf16
    GEMM with an fp32 result (:class:`_DenseBf16`). Otherwise, as JAX
    promotes mixed operands, both go to fp32 first.
    """
    if x.dtype == torch.bfloat16 and weight.dtype == torch.bfloat16:
        return _DenseBf16.apply(x, weight, bias, out_dtype)
    b = None if bias is None else bias.float()
    # Contiguous, so that ATen's linear takes its flattened GEMM with the bias fused
    # whether or not the weight requires grad (it picks another path for a strided
    # input when it does not): a module and an exported program on the same weights
    # then give the same bits.
    return F.linear(x.float().contiguous(), weight.float(), b).to(out_dtype)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`gemm` cast to x's dtype."""
    return gemm(x, weight, bias, x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU whose backward reads the mask from the saved output (JAX ``relu``'s custom VJP).

    ``torch.relu`` already saves only its output and takes the gradient at 0
    as 0, which is what the JAX package's custom VJP adds to ``jnp.maximum``:
    the output is a residual of the down projection anyway, so no separate
    ``x > 0`` mask is kept.
    """
    return torch.relu(x)


class _Swish(torch.autograd.Function):
    """``(x * s, s)`` with s = sigmoid(x); s is handed to the backward, not differentiated."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        s = torch.reciprocal(1 + torch.exp(-x))
        return x * s, s

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(inputs[0], output[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor, _: torch.Tensor) -> torch.Tensor:
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def swish(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` rounded as ``jax.nn.swish`` rounds it on the CPU.

    Every elementwise op runs in fp32 and rounds to x's dtype, in JAX's order:
    ``x * (1 / (1 + exp(-x)))``; in bf16 this is bit-equal to JAX on every
    bf16 value (``F.silu`` rounds once and differs on a quarter of them). The
    backward is JAX's logistic rule, ``g * s + (g * x) * (s * (1 - s))`` with
    the same per-op rounding; differentiating the forward's ops instead would
    give ``0 * inf`` below x = -88, where ``exp(-x)`` overflows.
    """
    return _Swish.apply(x)[0]


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with gain ``1 + scale``; ``scale`` None (folded into the next GEMM) only
    normalizes.

    The gain is formed and applied in fp32 whatever its storage dtype, as
    JAX's compiled programs keep it (XLA does not round the fused ``1 + scale``
    of a bf16-stored gain back to bf16).
    """
    if x.dtype == torch.float32:
        var = (x * x).mean(dim=-1, keepdim=True)
        normed = x * torch.rsqrt(var + eps)
        return normed if scale is None else normed * (1.0 + scale.float())
    # fp32 variance, x.dtype intermediates, fp32 gain with one final cast:
    # casting (1 + scale) to bf16 first would snap it to a ~0.004 grid.
    var = (x * x).float().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    if scale is None:
        return x * inv
    return ((x * inv).float() * (1.0 + scale.float())).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor | None, bias: torch.Tensor | None, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm with population variance; ``scale`` and ``bias`` None (folded into the
    next GEMM) only standardize. The affine is applied in fp32, as in :func:`rms_norm`."""
    if x.dtype == torch.float32:
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        std = (x - mu) * torch.rsqrt(var + eps)
        return std if scale is None else std * scale.float() + bias.float()
    mu32 = x.float().mean(dim=-1, keepdim=True)
    centered = x - mu32.to(x.dtype)
    var = (centered * centered).float().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    if scale is None:
        return centered * inv
    return ((centered * inv).float() * scale.float() + bias.float()).to(x.dtype)


class Dense(nn.Module):
    """Affine map with an (out, in) weight; see :func:`dense`.

    ``parallel`` is None, or (kind, axis) once ``parallel.shard_params`` gave
    this rank a block of the weight (``kind`` "column": rows of the weight and
    the bias, the input replicated; "row": columns of the weight, the input a
    block of features, the partial products kept in fp32 and summed over the
    model axis, the replicated bias added once after the sum, one cast to x's
    dtype: the rounding of the unsharded GEMM, as GSPMD reduces the fp32 dot).
    """

    parallel: tuple[str, ModelAxis] | None = None

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator, bias: bool = True) -> None:
        super().__init__()
        self.weight = nn.Parameter(xavier_uniform((out_dim, in_dim), generator))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    @classmethod
    def of(cls, weight: torch.Tensor, bias: torch.Tensor | None) -> "Dense":
        """A Dense holding ``weight`` (out, in) and ``bias`` as given, frozen."""
        module = cls.__new__(cls)
        nn.Module.__init__(module)
        module.weight = nn.Parameter(weight, requires_grad=False)
        module.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        return module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.parallel is None:
            return dense(x, self.weight, self.bias)
        kind, axis = self.parallel
        if kind == "column":
            return dense(copy_to_model(x, axis), self.weight, self.bias)
        y = reduce_from_model(gemm(x, self.weight, None, torch.float32), axis)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)

    def row_input(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated input of this Dense cut to the features its row-parallel block
        reads (``x`` as it is when the Dense is not row-parallel)."""
        if self.parallel is None or self.parallel[0] != "row":
            return x
        return scatter_to_model(x, self.parallel[1])


class RMSNorm(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


class LayerNorm(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


class ResidualBlock(nn.Module):
    """Residual MLP: ``output(act(hidden(x))) + residual(x)``; ``act`` is swish unless given
    (Chronos-2's patch embeddings use :func:`relu`)."""

    def __init__(
        self, in_dim: int, hidden_dim: int, out_dim: int, generator: torch.Generator,
        act: Callable[[torch.Tensor], torch.Tensor] = swish,
    ) -> None:
        super().__init__()
        self.act = act
        self.hidden = Dense(in_dim, hidden_dim, generator)
        self.output = Dense(hidden_dim, out_dim, generator)
        self.residual = Dense(in_dim, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(self.act(self.hidden(x))) + self.residual(x)


class Attention(nn.Module):
    """Multi-head causal self-attention with key padding and a learned per-dim query scale.

    Folded forms (frozen stacks; :func:`fold_seq1_attention`,
    :func:`fold_frozen_affines`): ``vo`` alone replaces ``qkv``, ``out`` and
    ``per_dim_scale`` (valid at one token only), or ``per_dim_scale`` is None
    and the q block of ``qkv`` arrives scaled.
    """

    def __init__(
        self, model_dims: int, num_heads: int, head_dim: int, generator: torch.Generator
    ) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.qkv = Dense(model_dims, 3 * num_heads * head_dim, generator)
        self.out = Dense(num_heads * head_dim, model_dims, generator)
        self.per_dim_scale = nn.Parameter(torch.zeros(head_dim))
        self.register_module("vo", None)

    def forward(self, x: torch.Tensor, paddings: torch.Tensor) -> torch.Tensor:
        """Counterpart of JAX ``causal_attention``, with its dispatch.

        Args:
            x: (B, S, model_dims).
            paddings: (B, S) bool, True = padded token.

        Dispatch: folded ``vo`` -> one GEMM (S must be 1); one token -> the v
        projection alone (softmax over one key is the identity). Otherwise a
        tensor that ``ops.attention.takes_kernels`` (any tensor not on the CPU;
        a CPU one while exporting) goes to a kernel entry point: the fused-qkv
        kernel at 8 <= S < 256 with S % 8 == 0 (B1, the TPU's border), the
        whole-sequence one at every other S up to 2,048 (B2), the flash one
        past 2,048 (B3); on the card no S reaches the plain path. A CPU
        tensor runs the plain path (JAX's XLA path).
        """
        batch, seq, _ = x.shape
        if self.vo is not None:
            if seq != 1:
                raise ValueError(
                    f"attention params were folded for seq==1 (fold_seq1_attention) "
                    f"but got seq={seq}; rebuild the model with unfolded params for "
                    "multi-token contexts"
                )
            return self.vo(x)
        heads, dim = self.num_heads, self.head_dim
        hd = heads * dim
        if seq == 1:
            bias = None if self.qkv.bias is None else self.qkv.bias[2 * hd :]
            out = dense(x, self.qkv.weight[2 * hd :], bias)
            return self.out(self.out.row_input(out.to(x.dtype)))

        qkv = self.qkv(x)  # (B, S, 3*H*D), column blocks q|k|v
        if self.per_dim_scale is not None:
            # Per-dim query scale on the q column block, fp32 multiply and one cast.
            scale = (_R_SOFTPLUS_0 / math.sqrt(dim)) * F.softplus(self.per_dim_scale.float())
            q = (qkv[..., :hd].float() * scale.repeat(heads)).to(qkv.dtype)
            if torch.is_grad_enabled():
                # A new tensor, as JAX's concatenate: writing into the projection
                # output would overwrite what the backward of the scale and of the
                # projection read. Grad mode, not ``qkv.requires_grad``: under
                # torch.func.vmap a batched tensor reports False though autograd
                # records the tensors under it.
                qkv = torch.cat([q, qkv[..., hd:]], dim=-1)
            else:
                # Nothing differentiates through it (serving): in place, which
                # saves a copy of qkv per layer.
                qkv[..., :hd] = q
        key_valid = ~paddings

        if supports_qkv_fused(qkv, seq, dim):
            out = fused_qkv_causal_attention(qkv, key_valid, heads, dim)
        else:
            q, k, v = split_heads(qkv, heads, dim)
            if supports_fused(qkv, seq, dim):
                out = fused_causal_attention(q, k, v, key_valid)
            elif needs_flash(qkv, seq, dim):
                out = flash_causal_attention(q, k, v, key_valid)
            elif takes_kernels(qkv):
                raise ValueError(f"head_dim {dim} is past the attention kernels' 256")
            else:
                out = plain_causal_attention(q, k, v, key_valid)
            out = out.reshape(batch, seq, hd)
        # qkv is replicated (every rank runs every head); a row-parallel out reads
        # this rank's block of the heads' features.
        return self.out(self.out.row_input(out.to(x.dtype)))


class TransformerLayer(nn.Module):
    """Pre-norm causal block: RMS norm -> attention -> residual; LayerNorm -> ReLU FFN ->
    padding-zeroed residual."""

    def __init__(
        self, model_dims: int, num_heads: int, head_dim: int, ffn_dims: int,
        generator: torch.Generator,
    ) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(model_dims)
        self.attn = Attention(model_dims, num_heads, head_dim, generator)
        self.ffn_norm = LayerNorm(model_dims)
        self.ffn_up = Dense(model_dims, ffn_dims, generator)
        self.ffn_down = Dense(ffn_dims, model_dims, generator)

    def forward(self, x: torch.Tensor, paddings: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), paddings)
        h = self.ffn_down(relu(self.ffn_up(self.ffn_norm(x))))
        h = h * (~paddings)[..., None].to(h.dtype)
        return x + h


class StackedTransformer(nn.Module):
    """``num_layers`` transformer layers run in order (the JAX package scans a stacked tree)."""

    def __init__(
        self, num_layers: int, model_dims: int, num_heads: int, head_dim: int, ffn_dims: int,
        generator: torch.Generator,
    ) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(model_dims, num_heads, head_dim, ffn_dims, generator)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, paddings: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, paddings)
        return x


# ---------------------------------------------------------------------------
# folds of a frozen stack (counterparts of JAX ``fold_seq1_attention``,
# ``fold_frozen_affines`` and their tree forms)
# ---------------------------------------------------------------------------


@torch.no_grad()
def fold_seq1_attention(stack: StackedTransformer) -> StackedTransformer:
    """Fold each layer's frozen attention into one (D, D) ``vo`` Dense, in place.

    At one causal position softmax runs over one key, so attention is
    ``out(v(x)) = x @ (Wv Wo) + (bv Wo + bo)``: the product is taken once in
    fp32 and stored in the weights' own dtype; ``qkv``, ``out`` and
    ``per_dim_scale`` go. Valid only for a frozen stack that sees one token
    (``Attention`` raises at S > 1). Idempotent: a folded layer is left as it is.
    """
    for layer in stack.layers:
        attn = layer.attn
        if attn.vo is not None:
            continue
        hd = attn.num_heads * attn.head_dim
        wo = attn.out.weight  # (D, H*Dh), (out, in)
        weight = (wo.float() @ attn.qkv.weight[2 * hd :].float()).to(wo.dtype)
        bias = attn.out.bias
        if attn.qkv.bias is not None:
            folded_bv = (wo.float() @ attn.qkv.bias[2 * hd :].float()).to(wo.dtype)
            bias = folded_bv if bias is None else bias + folded_bv
        attn.vo = Dense.of(weight, None if bias is None else bias.detach().clone())
        attn.qkv = attn.out = None
        attn.per_dim_scale = None
    return stack


@torch.no_grad()
def fold_frozen_affines(stack: StackedTransformer) -> StackedTransformer:
    """Fold each frozen layer's elementwise affines into its GEMM weights, in place.

    Three exact linear rewrites, taken in fp32 and stored in each weight's own
    dtype: the RMS gain ``1 + scale`` into the input columns of ``qkv`` (or of
    ``vo`` when :func:`fold_seq1_attention` ran first); the softplus'd per-dim
    query scale, tiled over the heads, into the q rows of ``qkv`` and its bias;
    the LayerNorm scale into ``ffn_up``'s input columns and its bias, through
    ``ffn_up``, into ``ffn_up``'s bias. The norms then only standardize and
    ``per_dim_scale`` goes. Valid at any sequence length for a frozen stack.
    Idempotent: a folded layer is left as it is.
    """
    for layer in stack.layers:
        if layer.attn_norm.scale is None:
            continue
        attn = layer.attn
        gain = 1.0 + layer.attn_norm.scale.float()  # (D,)
        if attn.vo is not None:
            vo = attn.vo.weight
            attn.vo.weight = nn.Parameter((vo.float() * gain).to(vo.dtype), requires_grad=False)
        else:
            qkv = attn.qkv
            weight = qkv.weight.float() * gain  # (3*H*Dh, D)
            if attn.per_dim_scale is not None:
                hd = attn.num_heads * attn.head_dim
                s = (_R_SOFTPLUS_0 / math.sqrt(attn.head_dim)) * F.softplus(attn.per_dim_scale.float())
                tiled = s.repeat(attn.num_heads)  # (H*Dh,)
                weight[:hd] *= tiled[:, None]
                if qkv.bias is not None:
                    bias = qkv.bias.float()
                    bias[:hd] *= tiled
                    qkv.bias = nn.Parameter(bias.to(qkv.bias.dtype), requires_grad=False)
                attn.per_dim_scale = None
            qkv.weight = nn.Parameter(weight.to(qkv.weight.dtype), requires_grad=False)
        layer.attn_norm.scale = None

        ln, up = layer.ffn_norm, layer.ffn_up
        w32 = up.weight.float()  # (F, D)
        weight = w32 * ln.scale.float()
        bias = w32 @ ln.bias.float()
        if up.bias is not None:
            bias = bias + up.bias.float()
        bias_dtype = up.weight.dtype if up.bias is None else up.bias.dtype
        up.weight = nn.Parameter(weight.to(up.weight.dtype), requires_grad=False)
        up.bias = nn.Parameter(bias.to(bias_dtype), requires_grad=False)
        ln.scale = ln.bias = None
    return stack


def fold_frozen_tree_seq1(adapter: nn.Module) -> nn.Module | None:
    """:func:`fold_seq1_attention` on an adapter's stack, in place; None (nothing folded)
    for an adapter without a TimesFM ``stacked_xf`` (Chronos-2). That every context the
    adapter will see is one patch token is the caller's to check."""
    stack = getattr(adapter, "stacked_xf", None)
    if not isinstance(stack, StackedTransformer):
        return None
    fold_seq1_attention(stack)
    return adapter


def fold_frozen_tree_affines(adapter: nn.Module) -> nn.Module | None:
    """:func:`fold_frozen_affines` on an adapter's stack, in place; None for an adapter
    without a TimesFM ``stacked_xf`` (Chronos-2's T5 encoder wires its norms otherwise)."""
    stack = getattr(adapter, "stacked_xf", None)
    if not isinstance(stack, StackedTransformer):
        return None
    fold_frozen_affines(stack)
    return adapter
