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
from repro_torch.kernels.ref import flash_attention_ref
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
    assert kflash.padded_head_dim(hd) == width


def test_padded_head_dim_above_256_raises():
    with pytest.raises(ValueError, match="head dim 300 is above 256"):
        kflash.padded_head_dim(300)


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
    pq, pk, pv, pout, pdout = kflash._pad_head(hd, q, k, v, out, dout)
    assert pq.shape[-1] == kflash.padded_head_dim(hd) and pq.is_contiguous()
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
