"""GPTQ: Hessian-based post-training int4 quantization (counterpart of
lit_llama_tpu/quant/gptq.py, the same algorithm as the reference's
lit_llama/quantization.py:426-616 and quantize/gptq.py:38-150).

* per-linear input Hessians H = sum 2 x xᵀ over the calibration batches, in
  full f32 (TF32 is held off while a model is quantized);
* the damped Cholesky inverse (damp = 0.01 · mean(diag H));
* a row-sequential walk with error feedback, lazily batched: rows inside a
  block update at once, the rest of the matrix once a block;
* optional ``actorder``: rows walked by descending diag(H) (a stable sort),
  each quantized against its natural group's static scale and zero;
* group scales re-estimated at every group boundary from the
  error-compensated rows.

Weights are (in, out), so the walk goes over rows. JAX's walk is a
``lax.fori_loop`` with no Pallas kernel; here it is plain torch on the
weights' device, about ten small launches a row. The calibration forwards of
``quantize_model_gptq`` go through ``ops.linear.linear`` and
``ops.attention.attention``, so on the card the quantized linears run K3 and
the attention K4, both in f32 (``plain`` runs their plain versions). The
output is the packed int4 layout of ``ops.linear``, which K1-K3 read as it
is.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.ops.attention import attention
from lit_llama_tpu_torch.ops.linear import linear, pack_int4
from lit_llama_tpu_torch.ops.norm import rms_norm
from lit_llama_tpu_torch.ops.rope import apply_rope, build_rope_cache

Params = Dict[str, Any]


def accumulate_hessian(H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """H += 2 xᵀx over the flattened batch, in place; returns H (reference:
    collect_input_stats, quantization.py:515-529; the factor cancels in the
    algorithm but matches)."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    return H.addmm_(x2.T, x2, alpha=2.0)


def _damped(H: torch.Tensor, damp_frac: float) -> torch.Tensor:
    """A copy of H with its dead columns' diagonal set to 1 and damp_frac ·
    mean(diag) added to the diagonal."""
    H = H.float().clone()
    diag = torch.diagonal(H)
    diag += (diag == 0.0).float()
    diag += damp_frac * diag.mean()
    return H


def _hinv_cholesky(H: torch.Tensor, damp_frac: float = 0.01) -> torch.Tensor:
    """Upper Cholesky factor U of H⁻¹ (H⁻¹ = UᵀU), with dead-column handling
    and damping (reference: quantization.py:541-556)."""
    H = _damped(H, damp_frac)
    L = torch.linalg.cholesky(H)
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.cholesky(Linv.T @ Linv).T


def _hinv_cholesky_host(H: torch.Tensor, damp_frac: float = 0.01) -> torch.Tensor:
    """LAPACK version of :func:`_hinv_cholesky` on the host, for very wide
    linears, in place on one f32 copy: potrf and trtri take no (n, n) identity
    right-hand side. Returns a CPU tensor."""
    from scipy.linalg import lapack

    H = np.array(H.cpu().numpy(), np.float32)  # a copy, mutated in place
    n = H.shape[0]
    dead = np.diag(H) == 0.0
    H[np.diag_indices(n)] += np.where(dead, np.float32(1.0), np.float32(0.0))
    damp = damp_frac * float(np.mean(np.diag(H)))
    H[np.diag_indices(n)] += np.float32(damp)
    L, info = lapack.spotrf(H, lower=1, overwrite_a=1)
    if info != 0:
        raise np.linalg.LinAlgError(f"spotrf failed: {info}")
    Linv, info = lapack.strtri(L, lower=1, overwrite_c=1)
    if info != 0:
        raise np.linalg.LinAlgError(f"strtri failed: {info}")
    Linv = np.tril(Linv)  # lapack leaves the strict upper triangle untouched
    L2, info = lapack.spotrf(Linv.T @ Linv, lower=1, overwrite_a=1)
    if info != 0:
        raise np.linalg.LinAlgError(f"spotrf(Hinv) failed: {info}")
    return torch.from_numpy(np.ascontiguousarray(np.tril(L2).T.astype(np.float32)))


def _group_params(blk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero) of rows ``blk`` (..., gs, out) over the rows: the range
    widened to hold 0, split into 15 steps."""
    wmin = blk.amin(dim=-2).clamp_(max=0.0)
    wmax = blk.amax(dim=-2).clamp_(min=0.0)
    return ((wmax - wmin) / 15.0).clamp_(min=1e-12), wmin


def gptq_quantize_matrix(
    w: torch.Tensor,  # (in, out)
    H: torch.Tensor,  # (in, in) f32
    groupsize: int = 128,
    blocksize: int = 128,
    actorder: bool = False,
    hinv: Optional[torch.Tensor] = None,  # precomputed upper Cholesky of the (permuted) H⁻¹
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q, scale, zero): q (in, out) uint8 levels in [0, 15], scale
    and zero (in/gs, out) f32. Asymmetric 4-bit per (group, output column).

    ``actorder=True`` walks rows in descending-diag(H) order, so the rows of
    high curvature quantize first and later rows absorb their error. Group
    scale and zero come from the original group membership ("static
    groups"), each permuted row quantizes against its natural group's, and
    the levels land straight back in natural order: the packed layout is
    unchanged and dequantization exact (reference: quantization.py:542-545,
    595-613, which re-quantizes on repack instead).
    """
    in_f, out_f = w.shape
    gs = in_f if groupsize == -1 else groupsize
    n_groups = in_f // gs
    blocksize = min(blocksize, in_f)
    while in_f % blocksize:
        blocksize //= 2
    dev = w.device
    w0 = w.float()

    if actorder:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        w = w0[perm]
        H = H[perm][:, perm]
        scales, zeros = _group_params(w0.reshape(n_groups, gs, out_f))
        out_rows = perm.tolist()
        group_of_row = (perm // gs).tolist()
    else:
        w = w0.clone()  # the walk updates it in place
        scales = torch.zeros((n_groups, out_f), dtype=torch.float32, device=dev)
        zeros = torch.zeros((n_groups, out_f), dtype=torch.float32, device=dev)
    # hinv (when given) was computed from the already permuted H
    Hinv = _hinv_cholesky(H) if hinv is None else hinv.float().to(dev)

    q = torch.empty((in_f, out_f), dtype=torch.uint8, device=dev)
    err_blk = torch.empty((blocksize, out_f), dtype=torch.float32, device=dev)
    for i0 in range(0, in_f, blocksize):
        i1 = i0 + blocksize
        blk, hblk = w[i0:i1], Hinv[i0:i1]  # views: the in-block updates land in w
        for i in range(blocksize):
            idx = i0 + i
            if actorder:
                g, out_row = group_of_row[idx], out_rows[idx]
            else:
                g, out_row = idx // gs, idx
                if idx % gs == 0:  # group boundary: scale and zero from the current rows
                    s, z = _group_params(w[g * gs : (g + 1) * gs])
                    scales[g], zeros[g] = s, z
            s, z = scales[g], zeros[g]
            wrow = blk[i]
            qrow = torch.round((wrow - z) / s).clamp_(0.0, 15.0)
            q[out_row] = qrow
            torch.div(wrow - (qrow * s + z), hblk[i, idx], out=err_blk[i])
            if i + 1 < blocksize:  # the rest of the block at once
                blk[i + 1 :] -= hblk[i, idx + 1 : i1, None] * err_blk[i]
        if i1 < in_f:  # the rows after the block, lazily
            w[i1:] -= hblk[:, i1:].T @ err_blk
    return q, scales, zeros


def pack_q4(q: torch.Tensor) -> torch.Tensor:
    """(in, out) levels -> (in//2, out) bytes in the half-split layout of
    ``ops.linear.pack_int4``: packed row i holds row i in its low nibble and
    row i + in//2 in its high nibble."""
    return pack_int4(q)


# ---------------------------------------------------------------------------
# Block-wise model quantization (reference: quantize/gptq.py:38-150)
# ---------------------------------------------------------------------------


def _attn_forward_tapped(lp, x, rope, mask, config, plain: bool = False):
    """Block forward that also returns the input each quantizable linear sees."""
    taps = {}
    h1 = rms_norm(x, lp["rms_1"])
    taps["attn.c_attn"] = h1
    y = _stage_attn(lp, h1, rope, mask, config, plain)
    taps["attn.c_proj"] = y
    x = x + linear(lp["attn"]["c_proj"], y, plain=plain)
    h2 = rms_norm(x, lp["rms_2"])
    taps["mlp.c_fc1"] = h2
    taps["mlp.c_fc2"] = h2
    gate = F.silu(linear(lp["mlp"]["c_fc1"], h2, plain=plain)) * linear(lp["mlp"]["c_fc2"], h2, plain=plain)
    taps["mlp.c_proj"] = gate
    x = x + linear(lp["mlp"]["c_proj"], gate, plain=plain)
    return x, taps


def _stage_attn(lp, h1, rope, mask, config: LLaMAConfig, plain: bool = False):
    """c_attn projection and causal attention: h1 = rms_1(x) -> the
    activations before c_proj. On the card K3 (a quantized c_attn) and K4."""
    B, T, _ = h1.shape
    H, hs = config.n_head, config.head_size
    qkv = linear(lp["attn"]["c_attn"], h1, plain=plain)
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    q = apply_rope(q.reshape(B, T, H, hs), rope).transpose(1, 2)
    k = apply_rope(k.reshape(B, T, H, hs), rope).transpose(1, 2)
    v = v.reshape(B, T, H, hs).transpose(1, 2)
    y = attention(q, k, v, mask, causal=True, plain=plain)
    return y.transpose(1, 2).reshape(B, T, H * hs)


_BLOCK_TARGETS = ("attn.c_attn", "attn.c_proj", "mlp.c_fc1", "mlp.c_fc2", "mlp.c_proj")


def _stage_concat(chunks: Iterable[torch.Tensor], host_spill: bool) -> torch.Tensor:
    """Join the per-batch stage outputs: on the host when spilling (each
    chunk leaves the card as it is made), else one tensor on the card."""
    if host_spill:
        return torch.cat([c.cpu() for c in chunks])
    return torch.cat(list(chunks))


def _get(d: Params, dotted: str):
    for k in dotted.split("."):
        d = d[k]
    return d


def _layer(h: Params, l: int, device) -> Params:
    """Layer ``l`` of the stacked tree on ``device``, as fresh dicts (of
    views where it lies there already)."""
    return {k: _layer(v, l, device) if isinstance(v, dict) else v[l].to(device) for k, v in h.items()}


def _copy_dicts(tree: Params) -> Params:
    """The tree's dicts copied, its tensors shared."""
    return {k: _copy_dicts(v) if isinstance(v, dict) else v for k, v in tree.items()}


@contextlib.contextmanager
def _ieee_f32():
    """Full f32 matrix products (no TF32) on the card while in the block."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def quantize_model_gptq(
    params: Params,
    config: LLaMAConfig,
    calib_tokens,  # (n_samples, T) ints
    groupsize: int = 128,
    batch: int = 4,
    actorder: bool = False,
    host_spill: Optional[bool] = None,
    plain: bool = False,
    device=None,
) -> Params:
    """Sequential block-wise GPTQ over the whole model: the five linears of
    each block, then lm_head, the error-compensated activations carried block
    to block (reference: llama_blockwise_quantization, quantize/gptq.py:38-150).
    ``params`` is the stacked tree (layers on a leading axis), in f32 as
    ``load_model(dtype="float32")`` gives it; it is not modified.

    Calibration is sequential within the block too, staged along its
    dataflow: each stage runs once with the weights quantized so far, and
    its outputs feed the next Hessian and the next stage:

      stage A: h1 = rms_1(x)                       -> H(c_attn); quantize it
      stage B: y = attn(c_attn_q(h1))              -> H(attn.c_proj); quantize
      stage C: x2 = x + c_proj_q(y); h2 = rms_2    -> H(c_fc1) = H(c_fc2); quantize
      stage D: gate = silu(fc1_q(h2)) * fc2_q(h2)  -> H(mlp.c_proj); quantize
      stage E: x = x2 + mlp.c_proj_q(gate)         (to the next block)

    ``host_spill`` (None: when the widest whole-corpus stage buffer
    (n, T, max(D, I)) in f32 would pass 2 GiB, as at 7B under the full
    128 × 2048 protocol): stage activations live in host memory with one
    ``batch`` on the card at a time, and the quantized leaves go to the host.
    ``plain`` runs the kernels' plain versions in the calibration forwards.
    ``device`` (default: where ``params`` lie) is where the work runs: the
    params may stay on the host (a 65B checkpoint does not fit a card), and
    then each layer's weights, lm_head and the embedding rows of a batch
    move to it when they are used.

    Returns the tree with the quantized leaf layout of
    ``llama.quantize_params(config.replace(quantize="int4"))``.
    """
    calib = calib_tokens if isinstance(calib_tokens, torch.Tensor) else torch.from_numpy(np.asarray(calib_tokens))
    calib = calib.long()
    n_samples, T = calib.shape
    wte = params["wte"]
    dev = wte.device if device is None else torch.device(device)
    rope = build_rope_cache(config.block_size, config.head_size, device=dev)[:T]
    mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    D, L = config.n_embd, config.n_layer
    if host_spill is None:
        host_spill = n_samples * T * max(D, config.intermediate_size) * 4 > 2 * 2**30
    starts = range(0, n_samples, batch)

    def batched(fn, *arrays):
        return _stage_concat((fn(*(a[b : b + batch].to(dev) for a in arrays)) for b in starts), host_spill)

    def hessian(t):
        H = torch.zeros((t.shape[-1],) * 2, dtype=torch.float32, device=dev)
        for b in starts if host_spill else (None,):  # a batch at a time from the host
            accumulate_hessian(H, t if b is None else t[b : b + batch].to(dev))
        return H

    def quantize_into(lp, t, H):
        node = _get(lp, t)
        hinv = None
        if host_spill and H.shape[0] >= 16384:
            # the triangular solve on the card holds several (n, n) temporaries at
            # this width: invert on the host (from the permuted H under actorder)
            Hh = H.cpu()
            if actorder:
                perm = torch.argsort(-torch.diagonal(Hh), stable=True)
                Hh = Hh[perm][:, perm]
            hinv = _hinv_cholesky_host(Hh)
        q, s, z = gptq_quantize_matrix(node.pop("w"), H, groupsize=groupsize, actorder=actorder, hinv=hinv)
        node.update(qw=pack_q4(q), qscale=s, qzero=z)  # on the card: the later stages run through them

    out = _copy_dicts(params)
    with _ieee_f32(), torch.no_grad():
        xs = batched(lambda c: wte[c.to(wte.device)].to(dev).float(), calib)
        for layer in range(L):
            lp = _layer(params["h"], layer, dev)
            # stage A: rms_1 output -> c_attn Hessian
            h1 = batched(lambda x: rms_norm(x, lp["rms_1"]), xs)
            quantize_into(lp, "attn.c_attn", hessian(h1))
            # stage B: attention outputs through the quantized c_attn -> c_proj Hessian
            y = batched(lambda h: _stage_attn(lp, h, rope, mask, config, plain), h1)
            del h1
            quantize_into(lp, "attn.c_proj", hessian(y))
            # stage C: residual + quantized c_proj -> rms_2 output; c_fc1 and c_fc2
            # share it, neither depending on the other, so one Hessian serves both
            x2 = batched(lambda x, yy: x + linear(lp["attn"]["c_proj"], yy, plain=plain), xs, y)
            del y
            h2 = batched(lambda x: rms_norm(x, lp["rms_2"]), x2)
            H_fc = hessian(h2)
            quantize_into(lp, "mlp.c_fc1", H_fc)
            quantize_into(lp, "mlp.c_fc2", H_fc)
            del H_fc
            # stage D: the SwiGLU gate through the quantized up-projections
            gate = batched(lambda h: F.silu(linear(lp["mlp"]["c_fc1"], h, plain=plain))
                           * linear(lp["mlp"]["c_fc2"], h, plain=plain), h2)
            del h2
            quantize_into(lp, "mlp.c_proj", hessian(gate))
            # stage E: through the fully quantized block
            xs = batched(lambda x, g: x + linear(lp["mlp"]["c_proj"], g, plain=plain), x2, gate)
            del x2, gate
            # the quantized leaves into the stacked tree (on the host when spilling)
            for t in _BLOCK_TARGETS:
                dst, src = _get(out["h"], t), _get(lp, t)
                if "w" in dst:
                    dst.pop("w")
                    for k, v in src.items():
                        dst[k] = torch.zeros((L,) + tuple(v.shape), dtype=v.dtype,
                                             device="cpu" if host_spill else v.device)
                for k, v in src.items():
                    dst[k][layer] = v
            del lp

        # lm_head on the final norm's output (reference: quantize/gptq.py:131-150)
        Hlm = torch.zeros((D, D), dtype=torch.float32, device=dev)
        ln_f = params["ln_f"].to(dev)
        for b in starts:
            accumulate_hessian(Hlm, rms_norm(xs[b : b + batch].to(dev), ln_f))
        q, s, z = gptq_quantize_matrix(params["lm_head"]["w"].to(dev), Hlm, groupsize=groupsize, actorder=actorder)
        leaves = {"qw": pack_q4(q), "qscale": s, "qzero": z}
        out["lm_head"] = {k: v.cpu() for k, v in leaves.items()} if host_spill else leaves
    return out
