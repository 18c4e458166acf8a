"""The schedules of ``relation_bias_v4_fwd`` (``csrc/relation_bias.cu``),
``relation_bias_rel_fwd`` (``csrc/relation_bias_rel.cu``),
``sep_contract_fwd`` and ``tiled_core_fwd`` (``csrc/tiled_msda.cu``),
emulated on the CPU in float32 from what their wrappers hand them, against
the plain versions and the JAX Pallas kernels (interpret mode).

relation_bias_v4_fwd: the block tiles (128 columns x R rows, R read from the
source by head count) with their clamped loads and masked stores, the
per-block prologue (rows' alpha|beta from the weights read through their
strides), each column's cos|sin features, the kernel's order of FMAs and its
sine-cosine argument reduction (``sincos_rr``, ``csrc/common.cuh``), whose
error against float64 is held over the whole range of angles.
relation_bias_rel_fwd: the flat pair tiles (threads x P pairs, P read from
the source by head count) with masked loads and stores, each pair's 32
sine-cosine pairs by ``sincos_rr`` and the FMAs in the kernel's order.
sep_contract_fwd: the 128-slot token passes, the chunks of whole patch rows
with the build threads' even and odd columns, each A element's FMA chain
over the points, and the register tiles of 4 tokens x 4 channels summing
the rows in ascending order. tiled_core_fwd: the token passes of a block
over an item, entries outside [0, M) skipped (their NaN weights too) and
the others summed in ascending order. A fused
multiply-add is emulated in float64 and rounded once to float32 (the
product of two float32 values is exact in float64). The card holds the
kernels themselves: ``chip_smoke.py`` phase 3 and the card-only tests in
``test_torch_no_jax.py``, on the same edge shapes.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relation_detr_tpu.ops import relation_pallas
from relation_detr_tpu.ops.msda_pallas import tiled_matmul_core as j_tiled_core
from relation_detr_tpu.ops.msda_sep_pallas import sep_contract_fused as j_sep
from relation_detr_tpu.ops.relation_pallas import fused_relation_bias_v4
from relation_detr_tpu_torch.ops import msda_tiled, relation_bias

from msda_inputs import (REL_CASES, SEP_CASES, TILED_FWD_CASES, V4_CASES, relation_boxes,
                         relation_rel, sep_operands, tiled_fwd_operands)

CSRC = Path(relation_bias.__file__).resolve().parent.parent / "csrc"
COMMON_SRC = (CSRC / "common.cuh").read_text()
V4_SRC = (CSRC / "relation_bias.cu").read_text()
REL_SRC = (CSRC / "relation_bias_rel.cu").read_text()
TILED_SRC = (CSRC / "tiled_msda.cu").read_text()
K = {}
for src in (V4_SRC, REL_SRC, TILED_SRC):
    for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src):
        assert K.setdefault(name, int(v)) == int(v), name  # one value per name
ROWS = {4: K["kRowsH4"], 8: K["kRowsH8"], 16: K["kRowsH16"]}
PAIRS = {4: K["kPairsH4"], 8: K["kPairsH8"], 16: K["kPairsH16"]}
F32 = np.float32
# jitted: one XLA compile runs the interpret-mode kernels far quicker than
# op-by-op dispatch
J_V4 = jax.jit(fused_relation_bias_v4)
J_SEP = jax.jit(j_sep)
J_TILED = jax.jit(j_tiled_core, static_argnums=3)
# relation version 2's kernel (the version is read when the call is traced;
# version 1's kernel computes the same function and compiles ~20x slower in
# interpret mode: test_torch_tiled.py holds the port against both)
J_REL_V2 = jax.jit(relation_pallas.fused_relation_bias)

# sincos_rr's constants, as the source writes them
TWO_OVER_PI = F32(0.636619772)
SHIFT = F32(float.fromhex("0x1.8p+23"))
C1 = F32(float.fromhex("0x1.921fb6p+0"))
C2 = F32(float.fromhex("0x1.777a5cp-25"))
SIN = (F32(-1.9515295891e-4), F32(8.3321608736e-3), F32(-1.6666654611e-1))
COS = (F32(2.443315711809948e-5), F32(-1.388731625493765e-3), F32(4.166664568298827e-2))
for literal in ("0.636619772f", "0x1.8p+23f", "0x1.921fb6p+0f", "0x1.777a5cp-25f",
                "-1.9515295891e-4f", "8.3321608736e-3f", "-1.6666654611e-1f",
                "2.443315711809948e-5f", "-1.388731625493765e-3f", "4.166664568298827e-2f"):
    assert literal in COMMON_SRC, literal


def fma(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def sincos_rr(x):
    """The kernel's sin and cos of float32 x."""
    x = np.asarray(x, F32)
    with np.errstate(invalid="ignore"):
        t = fma(x, TWO_OVER_PI, SHIFT)
        q = t - SHIFT
        r = fma(q, -C1, x)
        r = fma(q, C2, r)
        z = r * r
        sr = fma(fma(fma(z, SIN[0], SIN[1]), z, SIN[2]) * z, r, r)
        cr = fma(fma(fma(z, COS[0], COS[1]), z, COS[2]) * z, z, fma(F32(-0.5), z, F32(1.0)))
        qi = np.where(np.isfinite(t), t.view(np.int32), 0)
    odd = (qi & 1) == 1
    ss, cc = np.where(odd, cr, sr), np.where(odd, sr, cr)
    return (np.where((qi & 2) == 2, -ss, ss).astype(F32),
            np.where(((qi + 1) & 2) == 2, -cc, cc).astype(F32))


def test_sincos_reduction_error_over_the_angle_range():
    """sincos_rr against float64 sin / cos of the same float32 angle: the
    xy angles (0 to 100 log(1e8 + 1) ~ 1842 rad, every float32 in
    [1800, 1842] and a dense draw below) and the wh angles (to +-9e3
    rad: log(w + eps) x 100 for any finite width). Held at 1.5e-7 (9.2e-8
    on these draws; torch's float32 sin / cos: 3.6e-8); NaN and Inf angles
    give NaN."""
    top = np.float32(100.0) * np.log(np.float32(1e8 + 1.0))
    rng = np.random.RandomState(0)
    lo = np.arange(np.float32(1800.0).view(np.int32), top.view(np.int32) + 1,
                   dtype=np.int32).view(F32)
    xs = np.concatenate([lo, rng.uniform(0, 1842.1, 1_000_000).astype(F32),
                         rng.uniform(-9e3, 9e3, 500_000).astype(F32),
                         np.float32(np.pi / 4) * np.arange(-20, 21, dtype=F32)])
    s, c = sincos_rr(xs)
    x64 = xs.astype(np.float64)
    err = max(np.abs(s - np.sin(x64)).max(), np.abs(c - np.cos(x64)).max())
    assert err < 1.5e-7, err
    s, c = sincos_rr(np.array([np.nan, np.inf, -np.inf], F32))
    assert np.isnan(s).all() and np.isnan(c).all()


def emulate_relation_v4(src, tgt, kernel, bias, embed_dim=16, temperature=10000.0,
                        scale=100.0, eps=1e-5):
    """relation_bias_v4_fwd block by block: returns the output and how many
    times each element was stored."""
    bs, n1, _ = src.shape
    n2 = tgt.shape[1]
    heads = kernel.shape[1]
    rows, cols = ROWS[heads], K["kCols"]
    half = embed_dim // 2
    freqs = relation_bias._freqs(embed_dim, temperature, scale)
    eps = F32(eps)
    out = np.zeros((bs, heads, n1, n2), F32)
    stores = np.zeros(out.shape, np.int64)
    w_xy, w_wh = kernel[:2 * embed_dim], kernel[2 * embed_dim:]
    for b in range(bs):
        for i0 in range(0, n1, rows):
            ri = np.minimum(i0 + np.arange(rows), n1 - 1)
            box = src[b, ri].copy()  # (R, 4): cx, cy, w + eps, h + eps
            box[:, 2:] += eps
            # prologue: the rows' alpha|beta, (R, 2E, H)
            ab = np.zeros((rows, 4 * half, heads), F32)
            for ck in range(2 * half):
                with np.errstate(invalid="ignore", divide="ignore"):
                    sp, cp = sincos_rr(np.log(box[:, 2 + ck // half]) * freqs[ck % half])
                ws, wc = w_wh[2 * ck], w_wh[2 * ck + 1]
                ab[:, 2 * ck] = sp[:, None] * ws + cp[:, None] * wc
                ab[:, 2 * ck + 1] = sp[:, None] * wc - cp[:, None] * ws
            for j0 in range(0, n2, cols):
                j = j0 + np.arange(cols)
                live = (j // 32) * 32 < n2  # whole warps past N2 leave
                j, jc = j[live], np.minimum(j[live], n2 - 1)
                tb = tgt[b, jc]
                acc = np.broadcast_to(bias, (rows, len(j), heads)).astype(F32)
                bq = np.zeros((len(j), 4 * half), F32)
                for c in range(2):
                    with np.errstate(invalid="ignore", divide="ignore"):
                        q = np.log(tb[:, 2 + c] + eps)
                    for k in range(half):
                        s, co = sincos_rr(q * freqs[k])
                        bq[:, 2 * (c * half + k)], bq[:, 2 * (c * half + k) + 1] = co, s
                for f in range(4 * half):
                    acc = fma(ab[:, None, f, :], bq[None, :, f, None], acc)
                for c in range(2):
                    with np.errstate(invalid="ignore", divide="ignore"):
                        ratio = np.abs(box[:, None, c] - tb[None, :, c]) / box[:, None, 2 + c]
                        ratio = np.where(ratio < 1e8, ratio, F32(1e8))
                        ratio = np.where(ratio >= 0, ratio, F32(0)).astype(F32)
                        rel = np.log(ratio + F32(1.0))
                    for k in range(half):
                        s, co = sincos_rr(rel * freqs[k])
                        row = c * 2 * half + 2 * k
                        acc = fma(co[..., None], w_xy[row + 1], fma(s[..., None], w_xy[row], acc))
                keep_i = i0 + np.arange(rows) < n1
                keep_j = j < n2
                res = np.where(acc < 0, F32(0), acc)  # relu that keeps NaN
                for r in np.flatnonzero(keep_i):
                    out[b, :, i0 + r, j[keep_j]] = res[r][keep_j]
                    stores[b, :, i0 + r, j[keep_j]] += 1
    return out, stores


@pytest.mark.parametrize("batch,n1,n2,heads,layout", V4_CASES[:4])
def test_relation_v4_schedule_matches_plain_and_jax(batch, n1, n2, heads, layout):
    """The emulated kernel on the card tests' edge shapes (N1 != N2, cut
    row and column tiles, 4 / 8 / 16 heads, NaN / Inf centres and widths):
    every element stored once; finite where the plain version and the JAX
    kernel are, NaN elsewhere; values within 5e-5 of both (w/h down to
    10**-4.5: angles reach ~1.2e3 rad, where the three log implementations
    differ by an ulp on a few inputs, as in test_torch_ops.py)."""
    src, tgt, kernel, bias = relation_boxes(np.random.RandomState(n1), batch, n1, n2, heads)
    got, stores = emulate_relation_v4(src, tgt, kernel, bias)
    assert (stores == 1).all()
    plain = relation_bias.relation_bias_v4_reference(
        *(torch.from_numpy(a) for a in (src, tgt, kernel, bias))).numpy()
    jax_out = np.asarray(J_V4(*(jnp.asarray(a) for a in (src, tgt, kernel, bias))))
    for want in (plain, jax_out):
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        assert np.isnan(got[~finite]).all()
        np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=5e-5)
    wh_ok = np.isfinite(tgt[0, :, 2:]).all(-1)  # the NaN centre's row is clamped
    assert np.isfinite(got[0, :, 3 % n1, wh_ok]).all()


def emulate_sep_contract(oy, ox, patch):
    """sep_contract_fwd item by item (vectorised over the items): returns
    the output, how many times each A element was built per chunk pass, and
    how many times each output element was stored."""
    bs, nt, heads, points, ph, t = oy.shape
    pw = ox.shape[4]
    c = patch.shape[3]
    d = c // heads
    slots, chunk_rows, max_ky = K["kSepTokens"], K["kSepChunkRows"], K["kSepMaxKy"]
    # the kernel's form for the patch width: 10 columns a build thread, or 16
    x_slots = K["kSepXSlotsNarrow"] if pw <= 2 * K["kSepXSlotsNarrow"] else K["kSepXSlotsWide"]
    assert points <= K["kSepMaxP"] and pw <= 2 * x_slots and d % 4 == 0
    ky = max(1, min(max_ky, chunk_rows // pw))
    oy_i = oy.reshape(-1, points, ph, t)
    ox_i = ox.reshape(-1, points, pw, t)
    p_i = patch.reshape(bs, nt, ph * pw, heads, d).transpose(0, 1, 3, 2, 4).reshape(
        -1, ph * pw, d)
    out = np.zeros((len(oy_i), t, d), F32)
    stores = np.zeros(out.shape, np.int64)
    built = np.zeros((ph * pw, t), np.int64)
    for t0 in range(0, t, slots):
        tt = t0 + np.arange(slots)
        tv = tt < t
        tc = np.minimum(tt, t - 1)
        acc = np.zeros((len(oy_i), slots, d), F32)
        for k in range(-(-ph // ky)):
            y0 = k * ky
            ny = min(ky, ph - y0)
            a = np.zeros((len(oy_i), ny * pw, slots), F32)
            for xh in range(2):  # the build threads' even and odd columns
                for i in range(x_slots):
                    x = xh + 2 * i
                    if x >= pw:
                        break
                    for yy in range(ny):
                        oyv = np.where(tv, oy_i[:, :, y0 + yy, tc], 0)
                        oxv = np.where(tv, ox_i[:, :, x, tc], 0)
                        v = oyv[:, 0] * oxv[:, 0]
                        for p in range(1, points):
                            v = fma(oyv[:, p], oxv[:, p], v)
                        a[:, yy * pw + x] = v
                        built[(y0 + yy) * pw + x, tc[tv]] += 1
            for r in range(ny * pw):  # rows in ascending order, 4 x 4 tiles
                acc = fma(a[:, r, :, None], p_i[:, y0 * pw + r, None, :], acc)
        out[:, tt[tv]] = acc[:, tv]
        stores[:, tt[tv]] += 1
    out = out.reshape(bs, nt, heads, t, d).transpose(0, 1, 3, 2, 4).reshape(bs, nt, t, c)
    return out, built, stores


@pytest.mark.parametrize("batch,nt,heads,head_dim,points,ph,pw,tokens,dense", SEP_CASES)
def test_sep_contract_schedule_matches_plain_and_jax(batch, nt, heads, head_dim, points, ph,
                                                     pw, tokens, dense):
    """The emulated kernel on the card tests' edge shapes (odd M, T not a
    multiple of the tile and past one pass, 1 to 4 points, D 4 to 32,
    patches 1 high, 1 wide, 20 wide and 25 wide (the 16-column form)):
    every A element built once per item
    and pass, every output stored once, within 1e-5 abs of the plain
    version and of the JAX kernel."""
    oy, ox, patch = sep_operands(np.random.RandomState(ph * pw), batch, nt, heads, head_dim,
                                 points, ph, pw, tokens, dense)
    got, built, stores = emulate_sep_contract(oy, ox, patch)
    assert (built == 1).all() and (stores == 1).all()
    plain = msda_tiled.sep_contract_reference(*(torch.from_numpy(a) for a in (oy, ox, patch)))
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=1e-5)
    want = np.asarray(J_SEP(*(jnp.asarray(a) for a in (oy, ox, patch))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def emulate_relation_rel(rel, kernel, bias, embed_dim=16, temperature=10000.0, scale=100.0):
    """relation_bias_rel_fwd tile by tile: returns the output and how many
    times each element was stored."""
    bs, n1, n2, _ = rel.shape
    heads = kernel.shape[1]
    threads, per = K["kRelThreads"], PAIRS[heads]
    half = embed_dim // 2
    freqs = relation_bias._freqs(embed_dim, temperature, scale)
    pairs = n1 * n2
    flat = rel.reshape(bs, pairs, 4)
    out = np.zeros((bs, heads, pairs), F32)
    stores = np.zeros(out.shape, np.int64)
    for p0 in range(0, pairs, threads * per):
        # thread t of the block: pairs p0 + t + u * threads, u < per
        p = p0 + np.arange(per)[:, None] * threads + np.arange(threads)[None, :]
        live = p < pairs
        r = np.where(live[..., None], flat[:, np.minimum(p, pairs - 1)], F32(0))  # (B, P, T, 4)
        acc = np.broadcast_to(bias, (*r.shape[:3], heads)).astype(F32)
        for c in range(4):
            for k in range(half):
                s, co = sincos_rr(r[..., c] * freqs[k])
                row = c * 2 * half + 2 * k
                acc = fma(co[..., None], kernel[row + 1], fma(s[..., None], kernel[row], acc))
        res = np.where(acc < 0, F32(0), acc)  # relu that keeps NaN
        out[:, :, p[live]] = res[:, live].transpose(0, 2, 1)
        stores[:, :, p[live]] += 1
    return out.reshape(bs, heads, n1, n2), stores.reshape(bs, heads, n1, n2)


@pytest.mark.parametrize("batch,n1,n2,heads", REL_CASES[:4])
def test_relation_rel_schedule_matches_plain_and_jax(batch, n1, n2, heads):
    """The emulated relation_bias_rel_fwd on the card tests' edge shapes (one
    pair, N1 != N2, a last block cut short, 4 / 8 / 16 heads, |rel| up to
    90: angles to 9e3 rad) against the plain version and the JAX kernel of
    version 2: every element stored once, NaN where they are NaN (a NaN and
    an Inf in rel), 1e-5 abs elsewhere."""
    rel, kernel, bias = relation_rel(np.random.RandomState(n2), batch, n1, n2, heads)
    got, stores = emulate_relation_rel(rel, kernel, bias)
    assert (stores == 1).all()
    plain = relation_bias.fused_relation_bias_reference(
        *(torch.from_numpy(a) for a in (rel, kernel, bias))).numpy()
    try:
        relation_pallas.set_fused_relation(version=2)
        jax_out = np.asarray(J_REL_V2(*(jnp.asarray(a) for a in (rel, kernel, bias))))
    finally:
        relation_pallas.set_fused_relation(version=4)
    for want in (plain, jax_out):
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        assert np.isnan(got[~finite]).all()
        np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1e-5)
    assert np.isnan(got[0, :, n1 // 2, n2 // 3]).all()
    assert np.isnan(got[-1, :, n1 - 1, n2 - 1]).all()


def emulate_tiled_core_fwd(m, w, patch, dims):
    """tiled_core_fwd item by item (vectorised over the items, which the
    persistent grid takes in any order): returns the output and how many
    times each output element was stored."""
    bs, nt, heads, entries, tokens = m.shape
    rows = patch.shape[2]
    _, head_dim = dims
    assert head_dim in (4, 8, 16, 32) and entries * tokens % 4 == 0  # 16-byte staging
    per_pass = K["kFwdThreads"] // (head_dim // 4)
    m_i = m.reshape(-1, entries, tokens)
    w_i = w.reshape(-1, entries, tokens)
    p_i = patch.reshape(bs, nt, rows, heads, head_dim).transpose(0, 1, 3, 2, 4).reshape(
        -1, rows, head_dim)
    items = np.arange(len(m_i))[:, None]
    out = np.zeros((len(m_i), tokens, head_dim), F32)
    stores = np.zeros(out.shape, np.int64)
    for t0 in range(0, tokens, per_pass):
        tt = np.arange(t0, min(t0 + per_pass, tokens))
        acc = np.zeros((len(m_i), len(tt), head_dim), F32)
        for e in range(entries):  # ascending e; a row outside [0, M) is skipped
            row = m_i[:, e, tt]
            inside = (row >= 0) & (row < rows)
            v = p_i[items, np.clip(row, 0, rows - 1)]
            with np.errstate(invalid="ignore"):
                acc = np.where(inside[..., None], fma(w_i[:, e, tt, None], v, acc), acc)
        out[:, tt] = acc
        stores[:, tt] += 1
    out = out.reshape(bs, nt, heads, tokens, head_dim).transpose(0, 1, 3, 2, 4)
    return out.reshape(bs, nt, tokens, heads * head_dim), stores


@pytest.mark.parametrize("batch,nt,heads,head_dim,entries,tokens,rows", TILED_FWD_CASES)
def test_tiled_core_fwd_schedule_matches_plain_and_jax(batch, nt, heads, head_dim, entries,
                                                       tokens, rows):
    """The emulated tiled_core_fwd on the card tests' edge shapes (the
    flagship's level 0 item shape, M = 1, T not a multiple of 32, D 4 to 32)
    with rows outside [0, M) (-2, -1, M, M + 1, +-10**6) and NaN weights on
    them (dropped) and on one entry inside (its token's head slice NaN):
    every output stored once, the NaN pattern of the plain version and the
    JAX kernel, 1e-5 abs elsewhere."""
    m, w, patch = tiled_fwd_operands(np.random.RandomState(rows), batch, nt, heads, head_dim,
                                     entries, tokens, rows)
    dims = (heads, head_dim)
    got, stores = emulate_tiled_core_fwd(m, w, patch, dims)
    assert (stores == 1).all()
    plain = msda_tiled.tiled_core_reference(*(torch.from_numpy(a) for a in (m, w, patch)),
                                            dims).numpy()
    jax_out = np.asarray(J_TILED(*(jnp.asarray(a) for a in (m, w, patch)), dims))
    nan_slice = np.zeros(got.shape, bool)
    nan_slice[-1, -1, -1, (heads - 1) * head_dim:] = True
    for want in (plain, jax_out):
        np.testing.assert_array_equal(np.isnan(want), nan_slice)
        np.testing.assert_array_equal(np.isnan(got), nan_slice)
        np.testing.assert_allclose(got[~nan_slice], want[~nan_slice], rtol=0, atol=1e-5)


def test_tiled_core_fwd_wrapper_checks():
    """The CUDA wrapper's checks of tiled_core_fwd, run on CPU tensors: its
    two stages at the flagship's level 0 take 144,640 bytes (one block per
    SM), every level of the flagship fits, a patch whose two stages do not
    fit takes one (1500 rows), and a head dim the kernel does not take,
    E * T not a multiple of 4 and a patch too large for one stage raise."""
    assert msda_tiled._fwd_smem_bytes(437, 32, 16, 128) == 144640
    for rows in (437, 255, 182, 156):
        assert msda_tiled._fwd_smem_bytes(rows, 32, 16, 128) <= 232448
    assert msda_tiled._fwd_smem_bytes(1500, 32, 16, 128) == (1500 * 32 + 2 * 16 * 128) * 4

    def check(rows, heads, head_dim, t=8):
        m = torch.zeros(1, 2, heads, 16 if t % 4 == 0 else 3, t, dtype=torch.int32)
        w = torch.zeros(m.shape)
        patch = torch.zeros(1, 2, rows, heads * head_dim)
        msda_tiled._check_core_args(m, w, patch, (heads, head_dim))

    check(437, 8, 32, 128)
    with pytest.raises(ValueError, match="head dim"):
        check(20, 2, 64)
    with pytest.raises(ValueError, match="multiple of 4"):
        check(20, 2, 32, 5)
    check(1500, 8, 32, 128)
    with pytest.raises(ValueError, match="shared memory"):
        check(2000, 8, 32, 128)
