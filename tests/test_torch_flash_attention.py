"""The port's flash attention against the reference's, on the CPU.

The reference side runs as its own tests run it: the Pallas kernel
``flash_attention_pallas`` in interpret mode, its oracle
``repro.kernels.ref.flash_attention_ref`` and ``repro.kernels.ops``
with ``use_pallas=True, interpret=True`` (which pads S and masks the
padded keys with ``kv_len``). The port side runs its plain torch
version, which is what the kernel wrapper hands every CPU tensor to
(the CUDA kernel itself runs on the card only: tests/test_torch_cuda.py).

Tolerances are the reference's own (tests/test_kernels.py): float32
rtol = atol = 2e-5 (online vs dense softmax: another summation order),
bfloat16 rtol = atol = 2e-2 (one bf16 rounding of the output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.models import attention as attn

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _qkv(b, hq, hkv, s, hd, seed, layout="bhsd"):
    rng = np.random.default_rng(seed)
    if layout == "bhsd":
        shapes = [(b, hq, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)]
    else:
        shapes = [(b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _pair(arrays, dtype):
    """The same (rounded) inputs for both sides."""
    jdt, tdt, _ = DTYPES[dtype]
    js = [jnp.asarray(a, jdt) for a in arrays]
    ts = [torch.tensor(np.asarray(j, np.float32)).to(tdt) for j in js]
    return js, ts


# (b, hq, hkv, s, hd): GQA groups 1, 2 and 10 (recurrentgemma's MQA),
# head dims 64 and 256
SHAPES = [(2, 2, 2, 128, 64), (1, 4, 2, 256, 64), (1, 10, 1, 128, 256)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None), (False, 100)])
def test_plain_version_matches_pallas_and_oracle(shape, causal, window):
    b, hq, hkv, s, hd = shape
    (jq, jk, jv), (q, k, v) = _pair(_qkv(*shape, seed=s + hq), "float32")
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    got = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(q.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kv_len", [((1, 10, 1, 256, 256), 200),
                                          ((2, 4, 2, 128, 64), 1)])
def test_kv_len_matches_pallas(dtype, shape, kv_len):
    """Keys at and past ``kv_len`` masked, as the reference's wrapper
    masks its padding; rows that see no key come out 0 on both sides."""
    (jq, jk, jv), (q, k, v) = _pair(_qkv(*shape, seed=kv_len), dtype)
    for causal, window in ((True, None), (False, 64)):
        want = flash_attention_pallas(jq, jk, jv, causal=causal,
                                      window=window, kv_len=kv_len,
                                      interpret=True)
        got = kflash.flash_attention(q, k, v, causal=causal, window=window,
                                     kv_len=kv_len)
        assert got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window", [(200, None), (200, 64), (77, 16)])
def test_ops_ragged_length_matches_reference_ops(dtype, s, window):
    """Ragged S through both packages' ``ops``: the reference pads to its
    tile and masks with ``kv_len``; the port's kernel masks its own
    ragged edge."""
    shape = (1, 10, 1, s, 256) if s == 200 else (2, 4, 2, s, 64)
    (jq, jk, jv), (q, k, v) = _pair(_qkv(*shape, seed=s), dtype)
    want = ref_ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                   use_pallas=True, interpret=True)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("s,window", [(40, None), (40, 16), (33, 8)])
def test_model_attention_matches_reference(s, window):
    """``causal_attention``/``windowed_attention`` at the reference's
    (B, S, H, hd) layout against ``repro.models.attention``."""
    from repro.models import attention as ref_attn
    arrays = _qkv(2, 4, 1, s, 64, seed=s, layout="bshd")
    (jq, jk, jv), (q, k, v) = _pair(arrays, "float32")
    if window is None:
        want = ref_attn.causal_attention(jq, jk, jv)
        got = attn.causal_attention(q, k, v)
    else:
        want = ref_attn.windowed_attention(jq, jk, jv, window=window)
        got = attn.windowed_attention(q, k, v, window=window)
    assert tuple(got.shape) == tuple(q.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_attention_and_ring_cache_match_reference():
    from repro.models import attention as ref_attn
    rng = np.random.default_rng(4)
    b, t, hkv, hq, hd = 2, 8, 1, 4, 64
    kc = rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
    q = rng.standard_normal((b, 1, hq, hd)).astype(np.float32)
    kn = rng.standard_normal((b, 1, hkv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, 1, hkv, hd)).astype(np.float32)
    for pos in (3, 11):
        jc = ref_attn.cache_update({"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                   jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.int32(pos))
        tc = attn.cache_update({"k": torch.tensor(kc), "v": torch.tensor(vc)},
                               torch.tensor(kn), torch.tensor(vn), pos)
        np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
        np.testing.assert_array_equal(tc["v"].numpy(), np.asarray(jc["v"]))
        want = ref_attn.decode_attention(jnp.asarray(q), jc, jnp.int32(pos))
        got = attn.decode_attention(torch.tensor(q), tc, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# head dims the card's kernels are not built for: stablelm-3b's 80 (d_model
# 2560 over 32 heads) and 48; the reference kernel takes any hd
@pytest.mark.parametrize("hd", [80, 48])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, 100)])
def test_other_head_dims_match_pallas_and_oracle(hd, causal, window):
    shape = (1, 4, 2, 128, hd)
    (jq, jk, jv), (q, k, v) = _pair(_qkv(*shape, seed=hd), "float32")
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    got = kflash.flash_attention(q, k, v, causal=causal, window=window)
    assert tuple(got.shape) == tuple(q.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


def test_head_dim_80_bfloat16_matches_pallas():
    (jq, jk, jv), (q, k, v) = _pair(_qkv(1, 4, 2, 128, 80, seed=8),
                                    "bfloat16")
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=32,
                                  interpret=True)
    got = kflash.flash_attention(q, k, v, causal=True, window=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("hd,width", [(1, 64), (48, 64), (64, 64), (65, 128),
                                      (80, 128), (200, 256), (256, 256)])
def test_padded_head_dim_is_the_next_kernel_width(hd, width):
    """bfloat16 up to hd 256: the sm90 route at the next of its widths."""
    assert kflash.head_route(hd, torch.bfloat16) == ("sm90", width)


def test_padded_head_dim_above_256_raises():
    """Nothing raises above hd 256 any more (the name is from when it
    did): hd 300 and 512 take the f32 route in both dtypes, padded to a
    multiple of 8 (304, 512) and split over two column blocks of at most
    256 output columns."""
    for hd, width, cols in ((300, 304, 152), (512, 512, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            assert kflash.head_route(hd, dtype) == ("f32", width)
        geo = kflash.f32_geometry(1, 10, 1, 2048, width)
        assert (geo.col_blocks, geo.cols) == (2, cols)


@pytest.mark.parametrize("hd,width", [(1, 8), (48, 48), (64, 64), (65, 72),
                                      (80, 80), (256, 256), (257, 264),
                                      (320, 320), (1000, 1000)])
def test_float32_takes_the_f32_route_at_a_multiple_of_8(hd, width):
    assert kflash.head_route(hd, torch.float32) == ("f32", width)


# (b, hq, hkv, s, width): the training and serving shapes, column blocks
# at 304, 512 and 1000, a grid past the SMs, a prime group
@pytest.mark.parametrize("shape,col_blocks,cols,split", [
    ((1, 10, 1, 2048, 256), 1, 256, 10), ((4, 10, 1, 1024, 256), 1, 256, 10),
    ((1, 10, 1, 2048, 304), 2, 152, 10), ((1, 2, 1, 150, 512), 2, 256, 2),
    ((1, 2, 1, 97, 1000), 4, 256, 2), ((8, 16, 4, 4096, 64), 1, 64, 4),
    ((1, 7, 1, 300, 80), 1, 80, 7)])
def test_f32_geometry_splits_columns_and_the_group(shape, col_blocks, cols,
                                                   split):
    b, hq, hkv, s, width = shape
    geo = kflash.f32_geometry(b, hq, hkv, s, width)
    assert (geo.col_blocks, geo.cols, geo.split) == (col_blocks, cols, split)
    # the column blocks cover the width, none of them empty or too wide
    assert geo.cols % 8 == 0 and geo.cols <= kflash.F32_MAX_COLS
    assert geo.col_blocks * geo.cols >= width > (geo.col_blocks - 1) * geo.cols
    # the split divides the group and has the fewest waves of work,
    # ceil(blocks / SMs) / split, the largest such split on a tie
    group = hq // hkv
    blocks = -(-s // kflash.F32_KEY_BLOCK) * b * hkv * col_blocks

    def waves(d):
        return -(-blocks * d // kflash.H100_SMS) / d
    assert group % split == 0
    for d in range(1, group + 1):
        if group % d == 0:
            assert waves(split) < waves(d) or (waves(split) == waves(d)
                                               and split >= d)


def test_f32_operands_are_float32_padded_and_aligned():
    """What the f32 route hands its kernels: bfloat16 read as float32,
    hd zero-padded to the route's width, and a view off 16-byte alignment
    copied (cp.async reads 16-byte pieces)."""
    x = torch.arange(2 * 3 * 5 * 81, dtype=torch.float32)
    off = x[1:1 + 2 * 3 * 5 * 80].view(2, 3, 5, 80)      # 4 bytes off
    a, b = kflash._f32_operands(80, off, off.to(torch.bfloat16))
    assert a.dtype == b.dtype == torch.float32
    assert a.data_ptr() % 16 == 0 and torch.equal(a, off)
    assert torch.equal(b, off.to(torch.bfloat16).float())
    (c,) = kflash._f32_operands(88, off)
    assert c.shape[-1] == 88 and torch.equal(c[..., :80], off)
    assert not c[..., 80:].any()
    aligned = torch.zeros(2, 3, 5, 80)
    assert kflash._f32_operands(80, aligned)[0] is aligned


@pytest.mark.parametrize("hd", [80, 48])
def test_zero_padding_the_head_dim_leaves_attention_and_gradients(hd):
    """What the wrapper does on the card for a head dim the kernels are
    not built for, run through the plain versions: q, k, v (and out,
    dout) zero-padded to the next kernel width, the scale of the real hd,
    the result sliced back, equals the unpadded computation (exact in
    exact arithmetic: the zero columns add zeros to every q.k and every
    product with V; here within F32, since the host's matmuls may sum in
    another order at the padded width)."""
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    (_, _, _), (q, k, v) = _pair(_qkv(1, 4, 2, 96, hd, seed=hd + 1),
                                 "float32")
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(hd))
    masks = dict(causal=True, window=40, scale=hd ** -0.5)
    out, lse = flash_attention_ref(q, k, v, return_lse=True, **masks)
    width = kflash.head_route(hd, torch.bfloat16)[1]
    pq, pk, pv, pout, pdout = kflash._pad_head(width, q, k, v, out, dout)
    assert pq.shape[-1] == width and pq.is_contiguous()
    assert not pq[..., hd:].any()
    got, got_lse = flash_attention_ref(pq, pk, pv, return_lse=True, **masks)
    np.testing.assert_allclose(got[..., :hd].numpy(), out.numpy(), **F32)
    assert not got[..., hd:].any()
    np.testing.assert_allclose(got_lse.numpy(), lse.numpy(), **F32)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, **masks)
    grads = flash_attention_bwd_ref(pq, pk, pv, pout, pdout, lse, **masks)
    for name, g, w in zip("qkv", grads, want, strict=True):
        assert not g[..., hd:].any(), name
        np.testing.assert_allclose(g[..., :hd].numpy(), w.numpy(), **F32,
                                   err_msg=f"d{name}")


def test_cpu_takes_any_head_dim():
    """The plain version has no width of its own: hd 300, above what the
    card takes, runs on the CPU."""
    (_, _, _), (q, k, v) = _pair(_qkv(1, 2, 1, 20, 300, seed=3), "float32")
    got = kflash.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    (_, _, _), (q, k, v) = _pair(_qkv(1, 4, 2, 70, 64, seed=1), "float32")
    before = kflash.flash_attention.launches
    got = kflash.flash_attention(q, k, v, causal=True, window=20, kv_len=60)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True,
                                                window=20, kv_len=60))
    assert kflash.flash_attention.launches == before


@pytest.mark.parametrize("bad,err,match", [
    (dict(q=torch.zeros((1, 3, 8, 64))), ValueError, "Hq % Hkv"),
    (dict(q=torch.zeros((1, 4, 8, 0)), k=torch.zeros((1, 2, 8, 0)),
          v=torch.zeros((1, 2, 8, 0))), ValueError, "head dim"),
    (dict(q=torch.zeros((1, 4, 8, 64), dtype=torch.float16)), TypeError,
     "is torch.float32"),
    (dict(q=torch.zeros((1, 4, 8, 64), dtype=torch.float16),
          k=torch.zeros((1, 2, 8, 64), dtype=torch.float16),
          v=torch.zeros((1, 2, 8, 64), dtype=torch.float16)), TypeError,
     "float32 or bfloat16"),
    (dict(q=torch.zeros((1, 4, 64, 8)).transpose(2, 3)), ValueError,
     "contiguous"),
    (dict(k=torch.zeros((1, 2, 9, 64))), ValueError, r"k, v|do not match"),
    (dict(kv_len=9), ValueError, "kv_len"),
    (dict(window=0), ValueError, "window"),
])
def test_wrapper_rejects_malformed_operands(bad, err, match):
    args = dict(q=torch.zeros((1, 4, 8, 64)), k=torch.zeros((1, 2, 8, 64)),
                v=torch.zeros((1, 2, 8, 64)), window=None, kv_len=None)
    args.update(bad)
    with pytest.raises(err, match=match):
        kflash.flash_attention(args["q"], args["k"], args["v"],
                               window=args["window"], kv_len=args["kv_len"])


# ---- the backward ----------------------------------------------------------
# the plain backward version (dq, dk, dv recomputed from the saved
# log-sum-exp) against jax.grad of the reference's dense oracle, float32:
# rtol = atol = 2e-5 relative to the gradient's scale (sums in other
# orders, P recomputed from lse instead of a stored softmax)
GRAD_F32 = dict(rtol=2e-5, atol=2e-5)


def _jax_grads(fn, arrays, dout):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * dout)
    return jax.grad(loss, argnums=(0, 1, 2))(*arrays)


def _port_grads(q, k, v, dout, **masks):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = kflash.flash_attention(q, k, v, **masks)
    (out * dout).sum().backward()
    return q.grad, k.grad, v.grad


def _assert_grads(got, want):
    for name, g, w in zip("qkv", got, want, strict=True):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy() / scale, w / scale,
                                   **GRAD_F32, err_msg=f"d{name}")


# the last shape: head dim 80 (stablelm-3b's)
@pytest.mark.parametrize("shape", [(2, 4, 2, 80, 64), (1, 10, 1, 96, 256),
                                   (1, 4, 2, 72, 80)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None), (False, 40)])
def test_backward_matches_jax_grad_of_reference(shape, causal, window):
    arrays = _qkv(*shape, seed=shape[3] + (window or 0))
    dout = np.random.default_rng(9).standard_normal(
        shape[:2] + shape[3:]).astype(np.float32)
    (jq, jk, jv), (q, k, v) = _pair(arrays, "float32")
    want = _jax_grads(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=window), (jq, jk, jv),
        jnp.asarray(dout))
    got = _port_grads(q, k, v, torch.tensor(dout), causal=causal,
                      window=window)
    _assert_grads(got, want)


def test_backward_kv_len_matches_jax_grad_of_reference():
    """Causal with kv_len = S / 2: rows below kv_len are the causal
    attention of the first half; rows from kv_len on see exactly the
    first kv_len keys, the reference oracle's non-causal attention of
    those rows on them (a square problem at S = 2 kv_len)."""
    b, hq, hkv, s, hd = 1, 4, 2, 64, 64
    half = s // 2
    arrays = _qkv(b, hq, hkv, s, hd, seed=31)
    dout = np.random.default_rng(10).standard_normal(
        (b, hq, s, hd)).astype(np.float32)
    (jq, jk, jv), (q, k, v) = _pair(arrays, "float32")

    def ref(q_, k_, v_):
        first = jref.flash_attention_ref(q_[:, :, :half], k_[:, :, :half],
                                         v_[:, :, :half], causal=True)
        rest = jref.flash_attention_ref(q_[:, :, half:], k_[:, :, :half],
                                        v_[:, :, :half], causal=False)
        return jnp.concatenate([first, rest], axis=2)

    want = _jax_grads(ref, (jq, jk, jv), jnp.asarray(dout))
    got = _port_grads(q, k, v, torch.tensor(dout), causal=True, kv_len=half)
    _assert_grads(got, want)
    assert not got[1][:, :, half:].any() and not got[2][:, :, half:].any()


def test_backward_wrapper_on_the_cpu_is_the_plain_version():
    """The autograd Function's backward on CPU tensors is
    ``flash_attention_bwd_ref``, and neither counter moves."""
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    (_, _, _), (q, k, v) = _pair(_qkv(1, 4, 2, 50, 64, seed=2), "float32")
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    before = (kflash.flash_attention.launches,
              kflash.flash_attention_bwd.launches)
    got = _port_grads(q, k, v, dout, causal=True, window=16, kv_len=45)
    out, lse = flash_attention_ref(q, k, v, causal=True, window=16,
                                   kv_len=45, return_lse=True)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=True,
                                   window=16, kv_len=45)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert (kflash.flash_attention.launches,
            kflash.flash_attention_bwd.launches) == before
    # the backward of rows that see no key (window 16, kv_len 45: rows
    # 60 and on see nothing) is 0, and so is their output
    assert not out[:, :, 60:].any()


@pytest.mark.parametrize("bad,match", [
    (dict(out=torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16)), "out"),
    (dict(dout=torch.zeros((1, 4, 9, 64))), "dout"),
    (dict(lse=torch.zeros((1, 4, 8), dtype=torch.bfloat16)), "lse"),
    (dict(lse=torch.zeros((1, 4, 9))), "lse"),
])
def test_backward_wrapper_rejects_malformed_operands(bad, match):
    args = dict(q=torch.zeros((1, 4, 8, 64)), k=torch.zeros((1, 2, 8, 64)),
                v=torch.zeros((1, 2, 8, 64)), out=torch.zeros((1, 4, 8, 64)),
                dout=torch.zeros((1, 4, 8, 64)), lse=torch.zeros((1, 4, 8)))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        kflash.flash_attention_bwd(args["q"], args["k"], args["v"],
                                   args["out"], args["dout"], args["lse"])


# ---------------------------------------------------------------------------
# the bfloat16 kernels' launch geometry (computed on the host, no card)
# ---------------------------------------------------------------------------
# (b, hq, hkv, s, kv_len): recurrentgemma-2b's training shape (group 10
# on one kv head) and serving waves, ragged S, GQA groups, kv_len on and
# off a tile edge and 0, a prime group, a grid already past the SMs
GEOMETRY_SHAPES = [(1, 10, 1, 2048, None), (4, 10, 1, 1024, None),
                   (4, 10, 1, 4096, None), (1, 10, 1, 4097, 4000),
                   (1, 4, 2, 129, 100), (2, 2, 2, 64, 0), (1, 1, 1, 1, None),
                   (1, 2, 1, 63, 63), (1, 7, 1, 300, 128), (1, 12, 1, 65, 64),
                   (8, 16, 4, 4096, None), (1, 10, 1, 2049, 2048)]


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_launch_geometry_splits_the_group_and_covers_the_tiles(shape):
    b, hq, hkv, s, kv_len = shape
    sms = kflash.H100_SMS
    geo = kflash.launch_geometry(b, hq, hkv, s, kv_len, sms)
    group = hq // hkv
    key_blocks = -(-s // kflash.BWD_ROWS)
    # the split divides the group, and is the least that fills the SMs
    assert group % geo.split == 0
    blocks = geo.dkdv_grid[0] * geo.dkdv_grid[1] * geo.dkdv_grid[2]
    if key_blocks * b * hkv * group >= sms:
        assert blocks >= sms
        assert all(key_blocks * b * hkv * d < sms
                   for d in range(1, geo.split) if group % d == 0)
    else:
        assert geo.split == group
    assert geo.dkdv_grid == (key_blocks, geo.split, b * hkv)
    # every grid's tiles cover S exactly: the last tile holds row S - 1
    for grid, rows in ((geo.fwd_grid, kflash.FWD_ROWS),
                       (geo.dq_grid, kflash.BWD_ROWS),
                       (geo.dkdv_grid, kflash.BWD_ROWS)):
        assert grid[0] * rows >= s > (grid[0] - 1) * rows
    assert geo.fwd_grid[1:] == (hq, b) and geo.dq_grid[1:] == (hq, b)
    # the key tiles the kernels visit cover kv_len exactly
    kv = s if kv_len is None else kv_len
    assert geo.kv_tiles * kflash.BWD_ROWS >= kv
    assert kv == 0 and geo.kv_tiles == 0 or \
        (geo.kv_tiles - 1) * kflash.BWD_ROWS < kv


def test_launch_geometry_at_the_training_shape():
    """recurrentgemma-2b training (B 1, Hq 10, Hkv 1, S 2048): 32 key
    blocks alone leave 100 of 132 SMs idle; splitting the 10 query heads
    5 ways gives 160 blocks."""
    geo = kflash.launch_geometry(1, 10, 1, 2048)
    assert (geo.split, geo.dkdv_grid) == (5, (32, 5, 1))
    assert geo.fwd_grid == (16, 10, 1) and geo.dq_grid == (32, 10, 1)


# ---------------------------------------------------------------------------
# the f32 kernels' numerical design, emulated on the CPU: split TF32
# ---------------------------------------------------------------------------
NEG = -1e30


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_mm(a, b):
    """a @ b as the f32 kernels form it: each operand split into big =
    tf32(x) and small = tf32(x - big), then small big + big small + big
    big summed in float32 (a product of two TF32 values is exact in
    float32); only small small is dropped."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _single_mm(a, b):
    """a @ b in plain TF32: one product of the rounded operands."""
    return _tf32(a) @ _tf32(b)


def _visible(i, j, causal, window):
    vis = torch.ones(len(i), len(j), dtype=torch.bool)
    if causal:
        vis &= j[None] <= i[:, None]
    if window is not None:
        vis &= j[None] > i[:, None] - window
    return vis


def _emulated_forward(q, k, v, mm, *, causal, window, scale, tile=32):
    """The f32 forward kernel's order on q (Hq, S, hd), k, v (Hkv, S,
    hd): per 32-key tile the scores, the online softmax with the
    reference's guards (max clamped at -1e30 / 2, denominator at 1e-30),
    then acc += P V, every product through ``mm``."""
    hq, s, _ = q.shape
    kk = k.repeat_interleave(hq // k.shape[0], 0)
    vv = v.repeat_interleave(hq // k.shape[0], 0)
    i = torch.arange(s)
    m = torch.full((hq, s, 1), NEG)
    l = torch.zeros((hq, s, 1))
    acc = torch.zeros_like(q)
    for k0 in range(0, s, tile):
        j = torch.arange(k0, min(k0 + tile, s))
        vis = _visible(i, j, causal, window)
        sc = torch.where(vis, mm(q, kk[:, j].transpose(1, 2)) * scale, NEG)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        m_safe = m_new.clamp_min(NEG / 2)
        p = torch.where(vis, torch.exp(sc - m_safe), 0.0)
        alpha = torch.exp(m - m_safe)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vv[:, j])
        m = m_new
    return acc / l.clamp_min(1e-30)


def _emulated_backward(q, k, v, out, dout, lse, mm, *, causal, window,
                       scale):
    """The f32 backward kernels' products on one dense tile: P from the
    saved lse, dS = P (dO V^T - D), dq = scale dS K, dk = scale dS^T Q
    and dv = P^T dO summed over each kv head's query heads."""
    hq, s, hd = q.shape
    hkv = k.shape[0]
    kk = k.repeat_interleave(hq // hkv, 0)
    vv = v.repeat_interleave(hq // hkv, 0)
    i = torch.arange(s)
    vis = _visible(i, i, causal, window)
    p = torch.where(vis, torch.exp(mm(q, kk.transpose(1, 2)) * scale
                                   - lse[..., None]), 0.0)
    d = (dout * out).sum(-1, keepdim=True)
    ds = p * (mm(dout, vv.transpose(1, 2)) - d)
    dq = mm(ds, kk) * scale
    dk = (mm(ds.transpose(1, 2), q) * scale).view(hkv, -1, s, hd).sum(1)
    dv = mm(p.transpose(1, 2), dout).view(hkv, -1, s, hd).sum(1)
    return dq, dk, dv


def _design_case(hd, mm, window=40):
    """(emulated, pallas interpret, reference oracle, port plain) outputs
    and (emulated, jax.grad of the oracle, port plain) gradients of one
    tile: 4 query heads on 1 kv head, 96 rows, causal with a window."""
    shape = (1, 4, 1, 96, hd)
    (jq, jk, jv), (q, k, v) = _pair(_qkv(*shape, seed=hd + 2), "float32")
    dout = np.random.default_rng(hd).standard_normal(
        (1, 4, 96, hd)).astype(np.float32)
    scale = hd ** -0.5
    masks = dict(causal=True, window=window)
    fwd = (_emulated_forward(q[0], k[0], v[0], mm, scale=scale, **masks),
           np.asarray(flash_attention_pallas(jq, jk, jv, interpret=True,
                                             **masks))[0],
           np.asarray(jref.flash_attention_ref(jq, jk, jv, **masks))[0],
           flash_attention_ref(q, k, v, **masks)[0])
    out, lse = flash_attention_ref(q, k, v, return_lse=True, **masks)
    dt = torch.tensor(dout)
    bwd = (_emulated_backward(q[0], k[0], v[0], out[0], dt[0], lse[0], mm,
                              scale=scale, **masks),
           [np.asarray(g)[0] for g in _jax_grads(
               lambda a, b, c: jref.flash_attention_ref(a, b, c, **masks),
               (jq, jk, jv), jnp.asarray(dout))],
           [g[0] for g in flash_attention_bwd_ref(q, k, v, out, dt, lse,
                                                  **masks)])
    return fwd, bwd


@pytest.mark.parametrize("hd", [256, 80])
def test_split_tf32_design_meets_the_float32_tolerance(hd):
    """The kernels' arithmetic (split-TF32 products in the forward's tile
    order, and the backward's products) lands within the float32
    tolerance of the reference kernel in interpret mode, its oracle and
    the port's plain versions."""
    (got, pallas, oracle, plain), (grads, jax_grads, plain_grads) = \
        _design_case(hd, _split_mm)
    for want in (pallas, oracle, plain):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for want in (jax_grads, plain_grads):
        _assert_grads(grads, [np.asarray(w) for w in want])


@pytest.mark.parametrize("hd", [256, 80])
def test_single_tf32_misses_the_float32_tolerance(hd):
    """Why the products are split: one TF32 product (10 mantissa bits a
    factor) misses the float32 tolerance in the forward and the
    backward, by more than 10x the split's error."""
    (got, _, oracle, _), (grads, jax_grads, _) = _design_case(hd, _single_mm)
    (split_got, *_), _ = _design_case(hd, _split_mm)
    err = np.abs(got.numpy() - oracle).max()
    assert not np.allclose(got.numpy(), oracle, **F32)
    assert err > 10 * np.abs(split_got.numpy() - oracle).max()
    with pytest.raises(AssertionError):
        _assert_grads(grads, [np.asarray(w) for w in jax_grads])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_320_matches_pallas_and_oracle(dtype):
    """hd 320, above what the sm90 kernels take: the plain version (what
    the wrapper runs on the CPU, and the f32 kernels' yardstick on the
    card) against the reference kernel in interpret mode and its
    oracle."""
    shape = (1, 4, 2, 80, 320)
    (jq, jk, jv), (q, k, v) = _pair(_qkv(*shape, seed=320), dtype)
    masks = dict(causal=True, window=48)
    want = flash_attention_pallas(jq, jk, jv, interpret=True, **masks)
    oracle = jref.flash_attention_ref(jq, jk, jv, **masks)
    got = kflash.flash_attention(q, k, v, **masks)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == shape[:2] + \
        shape[3:]
    for ref_out in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref_out, np.float32),
                                   **DTYPES[dtype][2])
