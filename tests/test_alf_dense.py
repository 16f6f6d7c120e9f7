"""Parity: tpu/alf_dense dense whole-frame ALF/CC-ALF vs rcn/ref_alf
(the oracle-bit-exact scalar reference)."""

import numpy as np
import pytest

from types import SimpleNamespace

from openvvc_tpu.rcn.ref_alf import AlfFilters, apply_alf_entry
from openvvc_tpu.tpu import alf_dense
from openvvc_tpu.vcl.alf import AlfCtuParams


def _mk_aps_luma(rng):
    return SimpleNamespace(
        alf_luma_coeff_delta_idx=[int(rng.randint(0, 3)) for _ in range(25)],
        alf_luma_coeff=[[int(rng.randint(-127, 128)) for _ in range(12)]
                        for _ in range(3)],
        alf_luma_clip_flag=1,
        alf_luma_clip_idx=[[int(rng.randint(0, 4)) for _ in range(12)]
                           for _ in range(3)],
    )


def _mk_aps_chroma(rng, n_alt=2):
    return SimpleNamespace(
        alf_chroma_num_alt_filters_minus1=n_alt - 1,
        alf_chroma_coeff=[[int(rng.randint(-127, 128)) for _ in range(6)]
                          for _ in range(n_alt)],
        alf_chroma_clip_flag=1,
        alf_chroma_clip_idx=[[int(rng.randint(0, 4)) for _ in range(6)]
                             for _ in range(n_alt)],
    )


def _mk_cc(rng, n_filt=2):
    vals = [0, 1, 2, 4, 8, 16, 32, 64, -1, -2, -4, -8, -16, -32, -64]
    mk = lambda: [[int(rng.choice(vals)) for _ in range(7)]
                  for _ in range(n_filt)]
    return SimpleNamespace(alf_cc_cb_coeff=mk(), alf_cc_cr_coeff=mk())


def _rand_params(rng, ncw, nch, n_sets, n_alt, n_cc, density=0.8):
    params = {}
    for cy in range(nch):
        for cx in range(ncw):
            if rng.rand() > density:
                continue
            flag = int(rng.randint(0, 8))
            params[(cx, cy)] = AlfCtuParams(
                ctb_alf_flag=flag,
                ctb_alf_idx=int(rng.randint(0, n_sets)),
                cb_alternative=int(rng.randint(0, n_alt)),
                cr_alternative=int(rng.randint(0, n_alt)),
                cc_alf_idx=(int(rng.randint(0, n_cc + 1)),
                            int(rng.randint(0, n_cc + 1))),
            )
    return params


def _run_case(pic_w, pic_h, ctb_log2, bd, entries, seed, chroma=True):
    rng = np.random.RandomState(seed)
    ctu_s = 1 << ctb_log2
    ncw = (pic_w + ctu_s - 1) >> ctb_log2
    nch = (pic_h + ctu_s - 1) >> ctb_log2

    aps_list = [_mk_aps_luma(rng)]
    aps_chroma = _mk_aps_chroma(rng)
    filters = AlfFilters(aps_list, aps_chroma, bd)
    cc = _mk_cc(rng)
    cc_data = (cc, cc)
    n_sets = 16 + len(aps_list)
    params = _rand_params(rng, ncw, nch, n_sets, 2, 2)

    y = rng.randint(0, 1 << bd, (pic_h, pic_w)).astype(np.int32)
    cb = rng.randint(0, 1 << bd, (pic_h >> 1, pic_w >> 1)).astype(np.int32)
    cr = rng.randint(0, 1 << bd, (pic_h >> 1, pic_w >> 1)).astype(np.int32)

    # scalar reference (in place per entry)
    frame = SimpleNamespace(y=y.copy(), cb=cb.copy() if chroma else None,
                            cr=cr.copy() if chroma else None)
    for eb in entries:
        apply_alf_entry(frame, eb, ctb_log2, params, filters, cc_data, bd,
                        pic_w, pic_h)

    tabs = alf_dense.build_alf_tables(params, filters, cc_data, ctb_log2,
                                      pic_w, pic_h, chroma)
    assert tabs is not None
    dy, dcb, dcr = alf_dense.alf_frame(
        np, y, cb if chroma else None, cr if chroma else None, tabs,
        entries, ctb_log2, bd, pic_w, pic_h)
    np.testing.assert_array_equal(dy, frame.y)
    if chroma:
        np.testing.assert_array_equal(dcb, frame.cb)
        np.testing.assert_array_equal(dcr, frame.cr)
    return tabs, (y, cb, cr), (dy, dcb, dcr), params, filters, cc_data


@pytest.mark.parametrize("bd", [8, 10])
def test_alf_dense_np_full_frame(bd):
    # 3x2 CTUs of 64, full coverage, one entry
    _run_case(192, 128, 6, bd, [(0, 0, 3, 2)], seed=1 + bd)


def test_alf_dense_np_partial_bottom():
    # bottom CTU row partial: virtual boundary disabled there
    _run_case(192, 120, 6, 8, [(0, 0, 3, 2)], seed=7)


def test_alf_dense_np_ctu128_partial():
    _run_case(256, 200, 7, 10, [(0, 0, 2, 2)], seed=11)


def test_alf_dense_np_two_entries():
    # vertical tile split: entry borders pad independently
    _run_case(256, 128, 6, 8, [(0, 0, 2, 2), (2, 0, 2, 2)], seed=13)


def test_alf_dense_jnp_matches_np():
    import jax.numpy as jnp

    pic_w, pic_h, lg, bd = 128, 128, 6, 8
    entries = [(0, 0, 2, 2)]
    tabs, (y, cb, cr), (dy, dcb, dcr), params, filters, cc_data = _run_case(
        pic_w, pic_h, lg, bd, entries, seed=21)
    jy, jcb, jcr = alf_dense.alf_frame(
        jnp, jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), tabs,
        entries, lg, bd, pic_w, pic_h)
    np.testing.assert_array_equal(np.asarray(jy), dy)
    np.testing.assert_array_equal(np.asarray(jcb), dcb)
    np.testing.assert_array_equal(np.asarray(jcr), dcr)


@pytest.mark.parametrize("bd", [8, 10])
def test_alf_coeff_lookup_jnp_matches_np(bd):
    """The device coefficient/clip lookup is an integer index: equal to
    the numpy branch at the coefficient and clip extremes, and free of
    matmuls (a float32 matmul may run in TF32 on a GPU)."""
    import jax
    import jax.numpy as jnp

    from openvvc_tpu.rcn.ref_alf import _clip_lut

    rng = np.random.RandomState(bd)
    S = 4
    sets = np.zeros((S, 100, 26), np.int32)
    sets[:, :, :13] = rng.choice([-128, -127, -1, 0, 1, 126, 127],
                                 (S, 100, 13))
    sets[:, :, 13:] = rng.choice(np.asarray(_clip_lut(bd)), (S, 100, 13))
    assert sets[:, :, 13:].max() == 1 << bd
    cls = rng.randint(0, 25, (32, 48)).astype(np.int32)
    tr = rng.randint(0, 4, (32, 48)).astype(np.int32)
    slot = rng.randint(0, S, (32, 48)).astype(np.int32)

    want = alf_dense._resolve_coeffs(np, cls, tr, slot, sets)
    lookup = lambda c, t, s, st: alf_dense._resolve_coeffs(jnp, c, t, s, st)
    got = np.asarray(jax.jit(lookup)(cls, tr, slot, sets))
    np.testing.assert_array_equal(got, want)
    assert "dot_general" not in str(jax.make_jaxpr(lookup)(cls, tr, slot,
                                                           sets))
