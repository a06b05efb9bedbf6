"""The port's paged attention (paddle_tpu_torch.parallel.flash_attention)
held against the JAX package's, on the CPU.

The same seeded numpy inputs go to the JAX function — its Pallas kernel
in interpret mode and its plain reference — and to the port, whose CPU
tensors run the plain PyTorch version.  Tolerance: 2e-6 absolute in
float32 (values are O(1); the engines sum in different orders).  The
CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.parallel import flash_attention as jfa
from paddle_tpu_torch.parallel import flash_attention as tfa

TOL = 2e-6
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pools(rng, P, ps, H, Dh):
    return (rng.randn(P, ps, H, Dh).astype(np.float32),
            rng.randn(P, ps, H, Dh).astype(np.float32))


def _jax_decode(q, kp, vp, tables, lens, dtype, **kw):
    jd = DTYPES[dtype][0]
    return np.asarray(jfa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
        jnp.asarray(tables), jnp.asarray(lens), **kw))


def _port_decode(q, kp, vp, tables, lens, dtype):
    td = DTYPES[dtype][1]
    return tfa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp).to(td),
        torch.from_numpy(vp).to(td), torch.from_numpy(tables),
        torch.from_numpy(lens)).numpy()


def _jax_prefill(q, kp, vp, pages, start, dtype, **kw):
    jd = DTYPES[dtype][0]
    return np.asarray(jfa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
        jnp.asarray(pages), jnp.int32(start), **kw))


def _port_prefill(q, kp, vp, pages, start, dtype="float32"):
    td = DTYPES[dtype][1]
    return tfa.paged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kp).to(td),
        torch.from_numpy(vp).to(td), torch.from_numpy(pages),
        start).numpy()


def _decode_case(seed, lens, P=20, ps=4, H=2, Dh=16, mp=5):
    rng = np.random.RandomState(seed)
    S = len(lens)
    q = rng.randn(S, H, Dh).astype(np.float32)
    kp, vp = _pools(rng, P, ps, H, Dh)
    tables = np.stack([rng.choice(np.arange(1, P), mp, replace=False)
                       for _ in range(S)]).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


ENGINES = [pytest.param(dict(impl="pallas", interpret=True), id="pallas"),
           pytest.param(dict(impl="reference"), id="reference")]


class TestPagedDecode:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("engine", ENGINES)
    def test_mixed_lengths_match_jax(self, engine, dtype):
        q, kp, vp, tables, lens = _decode_case(0, [5, 1, 20, 13])
        want = _jax_decode(q, kp, vp, tables, lens, dtype, **engine)
        got = _port_decode(q, kp, vp, tables, lens, dtype)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_kv_lens_zero_is_exact_zeros(self, engine):
        q, kp, vp, tables, lens = _decode_case(1, [0, 7, 0])
        got = _port_decode(q, kp, vp, tables, lens, "float32")
        assert (got[0] == 0).all() and (got[2] == 0).all()
        assert np.abs(got[1]).sum() > 0
        want = _jax_decode(q, kp, vp, tables, lens, "float32", **engine)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_garbage_in_stale_page_tails(self, engine):
        # large finite garbage past each slot's length must not move the
        # result on either package
        q, kp, vp, tables, lens = _decode_case(2, [6, 3, 17])
        ps = kp.shape[1]
        kg, vg = kp.copy(), vp.copy()
        for s, n in enumerate(lens):
            last = tables[s, (n - 1) // ps]
            kg[last, n % ps or ps:] = 1e4
            vg[last, n % ps or ps:] = -1e4
            kg[tables[s, -(-n // ps):]] = 3e3   # unreached pages too
        clean = _port_decode(q, kp, vp, tables, lens, "float32")
        got = _port_decode(q, kg, vg, tables, lens, "float32")
        np.testing.assert_array_equal(got, clean)
        want = _jax_decode(q, kg, vg, tables, lens, "float32", **engine)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    def test_page_table_indirection_is_bitwise_inert(self):
        q, kp, vp, tables, lens = _decode_case(3, [9, 18, 4])
        P = kp.shape[0]
        perm = np.concatenate([[0], np.random.RandomState(9).permutation(
            np.arange(1, P))])
        inv = np.argsort(perm).astype(np.int32)
        a = _port_decode(q, kp, vp, tables, lens, "float32")
        b = _port_decode(q, kp[perm], vp[perm], inv[tables], lens,
                         "float32")
        assert a.tobytes() == b.tobytes()

    def test_matches_mha_reference_per_slot(self):
        q, kp, vp, tables, lens = _decode_case(4, [11, 2])
        got = _port_decode(q, kp, vp, tables, lens, "float32")
        S, mp = tables.shape
        _, ps, H, Dh = kp.shape
        for s in range(S):
            k = torch.from_numpy(kp[tables[s]].reshape(mp * ps, H, Dh))
            v = torch.from_numpy(vp[tables[s]].reshape(mp * ps, H, Dh))
            ref = tfa.mha_reference(
                torch.from_numpy(q[s])[None, :, None, :],
                k.transpose(0, 1)[None], v.transpose(0, 1)[None],
                kv_lens=torch.tensor([lens[s]]))
            np.testing.assert_allclose(got[s], ref[0, :, 0].numpy(),
                                       atol=TOL, rtol=0)


def _prefill_case(seed, C, P=11, ps=4, H=2, Dh=16, mp=6):
    rng = np.random.RandomState(seed)
    q = rng.randn(C, H, Dh).astype(np.float32)
    kp, vp = _pools(rng, P, ps, H, Dh)
    pages = rng.choice(np.arange(1, P), mp, replace=False).astype(np.int32)
    return q, kp, vp, pages


class TestPagedPrefill:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("engine", ENGINES)
    @pytest.mark.parametrize("start,C", [(0, 8), (4, 8), (12, 12)])
    def test_matches_jax(self, start, C, engine, dtype):
        q, kp, vp, pages = _prefill_case(start + C, C)
        want = _jax_prefill(q, kp, vp, pages, start, dtype, **engine)
        got = _port_prefill(q, kp, vp, pages, start, dtype)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_garbage_in_stale_page_tails(self, engine):
        # keys at or past start + C are stale: large finite garbage there
        # must not move any row
        start, C = 3, 8
        q, kp, vp, pages = _prefill_case(5, C)
        ps = kp.shape[1]
        kg, vg = kp.copy(), vp.copy()
        end = start + C
        kg[pages[end // ps], end % ps:] = 1e4
        vg[pages[end // ps], end % ps:] = -1e4
        kg[pages[end // ps + 1:]] = 5e3
        clean = _port_prefill(q, kp, vp, pages, start)
        got = _port_prefill(q, kg, vg, pages, start)
        np.testing.assert_array_equal(got, clean)
        want = _jax_prefill(q, kg, vg, pages, start, "float32", **engine)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    @pytest.mark.parametrize("start,C", [(0, 8), (4, 16)])
    def test_chunk_split_is_bitwise_equal(self, start, C):
        q, kp, vp, pages = _prefill_case(6, C)
        full = _port_prefill(q, kp, vp, pages, start)
        lo = _port_prefill(q[:C // 2], kp, vp, pages, start)
        hi = _port_prefill(q[C // 2:], kp, vp, pages, start + C // 2)
        assert np.concatenate([lo, hi]).tobytes() == full.tobytes()

    def test_page_indirection_is_bitwise_inert(self):
        q, kp, vp, pages = _prefill_case(7, 8)
        perm = np.array([0, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1])
        inv = np.argsort(perm).astype(np.int32)
        a = _port_prefill(q, kp, vp, pages, 4)
        b = _port_prefill(q, kp[perm], vp[perm], inv[pages], 4)
        assert a.tobytes() == b.tobytes()


class TestDispatch:
    def test_cpu_calls_do_not_count_as_kernel_launches(self):
        before = dict(tfa.KERNEL_LAUNCHES)
        q, kp, vp, tables, lens = _decode_case(8, [3, 0])
        _port_decode(q, kp, vp, tables, lens, "float32")
        qp, kp2, vp2, pages = _prefill_case(8, 4)
        _port_prefill(qp, kp2, vp2, pages, 0)
        assert tfa.KERNEL_LAUNCHES == before

    def test_reset_launch_counts(self):
        saved = dict(tfa.KERNEL_LAUNCHES)
        try:
            tfa.KERNEL_LAUNCHES["paged_decode_attention"] += 3
            tfa.reset_launch_counts()
            assert set(tfa.KERNEL_LAUNCHES.values()) == {0}
        finally:
            tfa.KERNEL_LAUNCHES.update(saved)

    def test_other_devices_raise(self):
        q = torch.zeros((1, 2, 32), device="meta")
        pool = torch.zeros((2, 4, 2, 32), device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            tfa.paged_decode_attention(
                q, pool, pool, torch.zeros((1, 1), dtype=torch.int32),
                torch.ones(1, dtype=torch.int32))
        with pytest.raises(ValueError, match="cpu or cuda"):
            tfa.paged_prefill_attention(
                q, pool, pool, torch.zeros(1, dtype=torch.int32), 0)
