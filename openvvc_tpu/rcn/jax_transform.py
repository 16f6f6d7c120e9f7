"""Batched inverse transforms + dequant on the device (JAX/XLA path).

The transform stage is where the decoder's matrix work lives: every coded TB is
a pair of matrix multiplies against constant transform matrices (DCT-II /
DST-VII / DCT-VIII). We batch all TBs of one size class and transform pair
across a frame (or wavefront) into a single einsum over [N, h, w].

All arithmetic is exact integer math in int32 (values fit: |coeff| < 2^16,
matrix < 2^8, sums < 2^15 * 2^8 * 64 = 2^29), matching the numpy reference
bit for bit (tested in tests/test_jax_kernels.py).

Replaces the reference's per-TB scalar/SIMD kernels
(/root/reference/libovvc/rcn_transform.c + x86/rcn_transform_sse.c ~10k LoC)
with one batched formulation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from openvvc_tpu.rcn.data_transform import MATRICES
from openvvc_tpu.rcn.ref_transform import _IQ_SCALE

# device constants are materialized per call (inside jit they become trace
# constants; caching them would leak tracers, and a module-level jnp.asarray
# would spin up the device client for numpy-only importers)


def _j_matrix(key):
    return jnp.asarray(MATRICES[key], jnp.int32)


_NP_IQ_TBL = np.array(_IQ_SCALE, np.int32)


def _iq_scale():
    return jnp.asarray(_NP_IQ_TBL)  # [2][6]


@partial(jax.jit, static_argnames=("log2_w", "log2_h", "dep_quant", "bitdepth"))
def dequant_batch(levels, qp, log2_w, log2_h, dep_quant, bitdepth):
    """Batched dequant: levels [N, h, w] int32, qp [N] int32 -> [N, h, w].

    Parity: rcn_dequant.c derive_dequant_sdh/dpq + dequant_sb(_neg).
    """
    log2_s = log2_w + log2_h
    q = qp + 1 if dep_quant else qp
    base_shift = (6 + (1 if dep_quant else 0)) - (15 - bitdepth) + (log2_s >> 1) + (log2_s & 1)
    shift = base_shift - q // 6
    scale = _iq_scale()[log2_s & 1, q % 6]

    # int32 is parity by construction: the reference's dequant_sb computes
    # (int32_t)(coeff * scale + add) >> shift (rcn_dequant.c:80-87)
    lv = levels.astype(jnp.int32)
    scale = scale.astype(jnp.int32)[:, None, None]
    shift = shift.astype(jnp.int32)[:, None, None]

    pos_shift = jnp.maximum(shift, 0)
    neg_shift = jnp.maximum(-shift, 0)
    add = jnp.where(shift > 0, (jnp.int32(1) << pos_shift) >> 1, 0)
    val = jnp.where(
        shift >= 0,
        (lv * scale + add) >> pos_shift,
        lv * (scale << neg_shift),
    )
    # symmetric +/-(2^15 - 1) clip (reference ov_clip_intp2 parity)
    return jnp.clip(val, -((1 << 15) - 1), (1 << 15) - 1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("tr_h", "tr_v", "log2_w", "log2_h", "bitdepth"))
def inverse_transform_batch(coeffs, tr_h, tr_v, log2_w, log2_h, bitdepth):
    """Batched 2-stage inverse transform: coeffs [N, h, w] -> residual [N, h, w].

    stage 1 (vertical):   tmp[n,x,y] = clip16((sum_k c[n,k,x] * Mv[k,y] + 64) >> 7)
    stage 2 (horizontal): out[n,y,x] = clip16((sum_k tmp[n,k,y] * Mh[k,x] + a2) >> s2)
    """
    h, w = 1 << log2_h, 1 << log2_w
    m_v = _j_matrix((tr_v, h))
    m_h = _j_matrix((tr_h, w))
    shift2 = 20 - bitdepth
    c = coeffs.astype(jnp.int32)
    tmp = jnp.einsum("nkx,ky->nxy", c, m_v, preferred_element_type=jnp.int32)
    tmp = jnp.clip((tmp + 64) >> 7, -(1 << 15), (1 << 15) - 1)
    out = jnp.einsum("nky,kx->nyx", tmp, m_h, preferred_element_type=jnp.int32)
    out = jnp.clip((out + (1 << (shift2 - 1))) >> shift2, -(1 << 15), (1 << 15) - 1)
    return out


@partial(jax.jit, static_argnames=("tr_h", "tr_v", "log2_w", "log2_h", "dep_quant", "bitdepth"))
def reconstruct_residual_batch(levels, qp, tr_h, tr_v, log2_w, log2_h, dep_quant, bitdepth):
    """dequant + inverse transform for a batch of same-class TBs."""
    dq = dequant_batch(levels, qp, log2_w, log2_h, dep_quant, bitdepth)
    return inverse_transform_batch(dq, tr_h, tr_v, log2_w, log2_h, bitdepth)


_NP_MATRICES = {k: np.asarray(v, np.int32) for k, v in MATRICES.items()}
_NP_IQ = np.array(_IQ_SCALE, np.int32)


def reconstruct_residual_batch_np(levels, qp, tr_h, tr_v, log2_w, log2_h,
                                  dep_quant, bitdepth):
    """Numpy twin of reconstruct_residual_batch (vectorized host path)."""
    log2_s = log2_w + log2_h
    q = qp + 1 if dep_quant else qp
    base_shift = (6 + (1 if dep_quant else 0)) - (15 - bitdepth) + (log2_s >> 1) + (log2_s & 1)
    shift = (base_shift - q // 6).astype(np.int32)[:, None, None]
    scale = _NP_IQ[log2_s & 1, q % 6].astype(np.int32)[:, None, None]
    lv = levels.astype(np.int32)
    pos_shift = np.maximum(shift, 0)
    neg_shift = np.maximum(-shift, 0)
    add = np.where(shift > 0, (1 << pos_shift) >> 1, 0)
    val = np.where(shift >= 0,
                   (lv * scale + add) >> pos_shift,
                   lv * (scale << neg_shift))
    dq = np.clip(val, -((1 << 15) - 1), (1 << 15) - 1).astype(np.int32)

    h, w = 1 << log2_h, 1 << log2_w
    m_v = _NP_MATRICES[(tr_v, h)]
    m_h = _NP_MATRICES[(tr_h, w)]
    shift2 = 20 - bitdepth
    tmp = np.einsum("nkx,ky->nxy", dq, m_v)
    tmp = np.clip((tmp + 64) >> 7, -(1 << 15), (1 << 15) - 1)
    out = np.einsum("nky,kx->nyx", tmp, m_h)
    return np.clip((out + (1 << (shift2 - 1))) >> shift2, -(1 << 15), (1 << 15) - 1)
