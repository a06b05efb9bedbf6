"""The port's attention (paddle_tpu_torch.parallel.flash_attention) held
against the JAX package's, on the CPU.

The same seeded numpy inputs go to the JAX function — its Pallas kernels
in interpret mode, or its plain reference — and to the port, whose CPU
tensors run the plain PyTorch versions.  Tolerances: paged attention and
the flash forward (out and lse) 2e-6 absolute in float32, the flash
backward (dq, dk, dv against ``jax.grad`` through the JAX package's
fused and scan engines) 1e-5 absolute; values are O(1) and the engines
sum in different orders.  The CUDA kernels themselves are held against
the same plain versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
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


# ---------------------------------------------------------------------------
# flash attention (training): forward kernel B1, fused backward B2
# ---------------------------------------------------------------------------

FLASH_BWD_TOL = 1e-5
# (causal, T, S, kv_lens): not causal and causal, T != S, an uneven tail
# past the 16-row blocks the JAX kernels run with, rows with kv_lens == 0
FLASH_CASES = [
    pytest.param(False, 32, 32, None, id="full"),
    pytest.param(True, 32, 32, None, id="causal"),
    pytest.param(False, 20, 44, [44, 7], id="T<S-tail-lens"),
    pytest.param(True, 24, 40, [40, 29], id="causal-T<S-lens"),
    pytest.param(True, 20, 20, [0, 13], id="causal-tail-zero"),
    pytest.param(False, 16, 24, [0, 0], id="all-zero"),
]


def _flash_case(seed, T, S, B=2, H=2, D=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, T, D).astype(np.float32)
    k = rng.randn(B, H, S, D).astype(np.float32)
    v = rng.randn(B, H, S, D).astype(np.float32)
    do = rng.randn(B, H, T, D).astype(np.float32)
    return q, k, v, do


def _jax_lens(lens):
    return None if lens is None else jnp.asarray(lens, jnp.int32)


def _port_lens(lens):
    return None if lens is None else torch.tensor(lens, dtype=torch.int32)


class TestFlashAttention:
    @pytest.mark.parametrize("causal,T,S,lens", FLASH_CASES)
    def test_forward_out_and_lse_match_jax(self, causal, T, S, lens):
        q, k, v, _ = _flash_case(T + S, T, S)
        scale = 1.0 / np.sqrt(q.shape[-1])
        want_out, want_lse = jfa._flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _jax_lens(lens),
            causal, scale, 16, 16, True)
        out, lse = tfa._flash_fwd_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            _port_lens(lens), causal, scale)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=TOL, rtol=0)
        got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), _port_lens(lens),
                                  causal)
        assert got.numpy().tobytes() == out.numpy().tobytes()
        if lens is not None:
            dead = np.asarray(lens) == 0
            assert (out.numpy()[dead] == 0).all()

    # the JAX package's engine, and the port's: its "pallas" pair against
    # the port's pair, its fused and scan engines against the port's auto
    @pytest.mark.parametrize("impl", ["fused", "scan", "pallas"])
    @pytest.mark.parametrize("causal,T,S,lens", FLASH_CASES)
    def test_backward_matches_jax_grad(self, causal, T, S, lens, impl,
                                       monkeypatch):
        monkeypatch.setattr(jfa, "FLASH_BWD_IMPL", impl)
        monkeypatch.setattr(tfa, "FLASH_BWD_IMPL",
                            "pair" if impl == "pallas" else "auto")
        q, k, v, do = _flash_case(T * S, T, S)
        jl = _jax_lens(lens)

        def loss(a, b, c):
            out = jfa.flash_attention(a, b, c, jl, causal, None, 16, 16, True)
            return (out * jnp.asarray(do)).sum()

        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        out = tfa.flash_attention(tq, tk, tv, _port_lens(lens), causal)
        got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=FLASH_BWD_TOL, rtol=0)
        if lens is not None:
            dead = np.asarray(lens) == 0
            for g in got:
                assert (g.numpy()[dead] == 0).all()

    def test_gradcheck_float64(self):
        rng = np.random.RandomState(11)
        q, k, v = (torch.from_numpy(rng.randn(2, 1, n, 4)).requires_grad_(True)
                   for n in (5, 7, 7))
        lens = torch.tensor([6, 0], dtype=torch.int32)
        assert torch.autograd.gradcheck(
            lambda a, b, c: tfa.flash_attention(a, b, c, lens, True),
            (q, k, v), eps=1e-6, atol=1e-6)

    def test_non_finite_keys_past_kv_lens_change_nothing(self):
        q, k, v, do = _flash_case(5, 12, 12)
        lens = [9, 4]
        kn, vn = k.copy(), v.copy()
        for b, n in enumerate(lens):
            kn[b, :, n:] = np.nan
            vn[b, :, n:] = np.inf

        def run(kk, vv):
            tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                          for x in (q, kk, vv))
            out = tfa.flash_attention(tq, tk, tv, _port_lens(lens), True)
            grads = torch.autograd.grad(out, (tq, tk, tv),
                                        torch.from_numpy(do))
            dk, dv = (g.numpy().copy() for g in grads[1:])
            for b, n in enumerate(lens):  # rows past kv_lens are zero
                assert (dk[b, :, n:] == 0).all() and (dv[b, :, n:] == 0).all()
            return [out.detach().numpy(), grads[0].numpy(), dk, dv]

        for a, b in zip(run(k, v), run(kn, vn)):
            assert a.tobytes() == b.tobytes()

    def test_kernel_wrappers_reject_bad_inputs_before_launch(self):
        # the wrappers' checks run before the kernel library is touched
        q, k, v, do = (torch.from_numpy(x) for x in _flash_case(4, 8, 8, D=32))
        lens = torch.tensor([8, 3], dtype=torch.int32)
        out, lse = tfa._flash_fwd_reference(q, k, v, lens, False, 0.2)
        with pytest.raises(ValueError, match="head_dim"):
            tfa._flash_fwd_cuda(q[..., :16], k[..., :16], v[..., :16], lens,
                                False, 0.2)
        with pytest.raises(TypeError, match="float32"):
            tfa._flash_fwd_cuda(q, k.double(), v, lens, False, 0.2)
        with pytest.raises(ValueError, match="kv_lens"):
            tfa._flash_fwd_cuda(q, k, v, lens.long(), False, 0.2)
        with pytest.raises(ValueError, match="lse"):
            tfa._flash_bwd_cuda(q, k, v, lens, out, lse[:, :, :4].contiguous(),
                                do, False, 0.2)

    @pytest.mark.parametrize("causal,T,S,lens", FLASH_CASES)
    def test_pair_reference_matches_jax_pair(self, causal, T, S, lens):
        """B3's plain version (16-row tiles) against the JAX package's
        Pallas pair in interpret mode, from the same (out, lse)."""
        q, k, v, do = _flash_case(T + 2 * S, T, S)
        scale = 1.0 / np.sqrt(q.shape[-1])
        jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
        jl = _jax_lens(lens)
        out, lse = jfa._flash_fwd(jq, jk, jv, jl, causal, scale, 16, 16, True)
        want = jfa._flash_bwd_pallas(causal, scale, 16, 16, True,
                                     (jq, jk, jv, jl, out, lse), jdo)
        got = tfa._flash_bwd_pair_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            _port_lens(lens), torch.from_numpy(np.array(out)),
            torch.from_numpy(np.array(lse)), torch.from_numpy(do), causal,
            scale, block_q=16, block_k=16)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=FLASH_BWD_TOL, rtol=0)
        if lens is not None:
            dead = np.asarray(lens) == 0
            for g in got:
                assert (g.numpy()[dead] == 0).all()

    def test_pair_gradcheck_float64(self, monkeypatch):
        """The pair's tiled gradient against numerical differences, with
        tiles smaller than the sequences (2 query rows, 3 keys) so that
        the tile walks and skips are exercised, and through
        flash_attention with the engine set to pair."""
        class Pair(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, lens):
                out, lse = tfa._flash_fwd_reference(q, k, v, lens, True, 0.5)
                ctx.save_for_backward(q, k, v, lens, out, lse)
                return out

            @staticmethod
            def backward(ctx, do):
                q, k, v, lens, out, lse = ctx.saved_tensors
                return tfa._flash_bwd_pair_reference(
                    q, k, v, lens, out, lse, do, True, 0.5, block_q=2,
                    block_k=3) + (None,)

        rng = np.random.RandomState(12)
        q, k, v = (torch.from_numpy(rng.randn(2, 2, n, 4)).requires_grad_(True)
                   for n in (5, 7, 7))
        lens = torch.tensor([6, 0], dtype=torch.int32)
        assert torch.autograd.gradcheck(
            lambda a, b, c: Pair.apply(a, b, c, lens), (q, k, v), eps=1e-6,
            atol=1e-6)
        monkeypatch.setattr(tfa, "FLASH_BWD_IMPL", "pair")
        assert torch.autograd.gradcheck(
            lambda a, b, c: tfa.flash_attention(a, b, c, lens, False),
            (q, k, v), eps=1e-6, atol=1e-6)

    def test_pair_non_finite_keys_past_kv_lens_change_nothing(self):
        q, k, v, do = (torch.from_numpy(x) for x in _flash_case(6, 40, 40))
        lens = torch.tensor([33, 5], dtype=torch.int32)
        kn, vn = k.clone(), v.clone()
        for b, n in enumerate(lens.tolist()):
            kn[b, :, n:] = float("nan")
            vn[b, :, n:] = float("inf")
        out, lse = tfa._flash_fwd_reference(q, k, v, lens, True, 0.25)
        clean = tfa._flash_bwd_pair_reference(q, k, v, lens, out, lse, do,
                                              True, 0.25, 16, 16)
        dirty = tfa._flash_bwd_pair_reference(q, kn, vn, lens, out, lse, do,
                                              True, 0.25, 16, 16)
        for a, b in zip(clean, dirty):
            assert a.numpy().tobytes() == b.numpy().tobytes()
        for b, n in enumerate(lens.tolist()):
            assert (clean[1][b, :, n:] == 0).all()
            assert (clean[2][b, :, n:] == 0).all()

    def test_causal_longer_queries_raise(self):
        q = torch.zeros((1, 1, 8, 16))
        k = torch.zeros((1, 1, 4, 16))
        with pytest.raises(ValueError, match="T <= S"):
            tfa.flash_attention(q, k, k, causal=True)

    def test_cpu_calls_do_not_count_and_other_devices_raise(self):
        before = dict(tfa.KERNEL_LAUNCHES)
        q, k, v, do = _flash_case(3, 8, 8)
        tq = torch.from_numpy(q).requires_grad_(True)
        out = tfa.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v))
        out.backward(torch.from_numpy(do))
        assert tfa.KERNEL_LAUNCHES == before
        meta = torch.zeros((1, 1, 4, 32), device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            tfa.flash_attention(meta, meta, meta)


# ---------------------------------------------------------------------------
# the backward engine switch (FLASH_BWD_IMPL) and the pair's wrapper
# ---------------------------------------------------------------------------


def _grads(lens, causal, seed=7, T=40, S=40):
    q, k, v, do = _flash_case(seed, T, S)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, _port_lens(lens), causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    plain = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = tfa._flash_fwd_reference(*plain, _port_lens(lens), causal,
                                      1.0 / np.sqrt(q.shape[-1]))
    args = (*plain, _port_lens(lens), o, lse, torch.from_numpy(do), causal,
            1.0 / np.sqrt(q.shape[-1]))
    return grads, args


class TestBackwardEngineSwitch:
    def test_env_var_is_read_at_import(self):
        """PADDLE_TPU_TORCH_FLASH_BWD seeds the engine at import
        (normalized; an unknown value warns and takes auto)."""
        import os
        import subprocess
        import sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = ("from paddle_tpu_torch.parallel import flash_attention as F;"
                "print('IMPL=' + F.FLASH_BWD_IMPL)")

        def run(val):
            env = dict(os.environ, PADDLE_TPU_TORCH_FLASH_BWD=val,
                       PYTHONPATH=os.pathsep.join(
                           [root] + [p for p in (os.environ.get("PYTHONPATH"),)
                                     if p]))
            out = subprocess.run([sys.executable, "-W", "always", "-c", code],
                                 env=env, capture_output=True, text=True,
                                 timeout=300)
            assert out.returncode == 0, out.stderr[-1000:]
            impl = [ln for ln in out.stdout.splitlines()
                    if ln.startswith("IMPL=")][0]
            return impl[len("IMPL="):], out.stderr

        impl, _ = run(" Pair ")
        assert impl == "pair"
        impl, err = run("pallas")
        assert impl == "auto" and "PADDLE_TPU_TORCH_FLASH_BWD" in err

    def test_unknown_value_set_at_run_time_raises(self, monkeypatch):
        monkeypatch.setattr(tfa, "FLASH_BWD_IMPL", "scan")
        with pytest.raises(ValueError, match="FLASH_BWD_IMPL"):
            _grads([40, 9], True)

    @pytest.mark.parametrize("engine", ["auto", "fused"])
    def test_auto_and_fused_on_cpu_give_the_plain_backward_bits(
            self, engine, monkeypatch):
        monkeypatch.setattr(tfa, "FLASH_BWD_IMPL", engine)
        grads, args = _grads([40, 9], True)
        want = tfa._flash_bwd_reference(*args)
        for g, w in zip(grads, want):
            assert g.numpy().tobytes() == w.numpy().tobytes()

    def test_pair_on_cpu_gives_the_pair_reference_bits(self, monkeypatch):
        monkeypatch.setattr(tfa, "FLASH_BWD_IMPL", "pair")
        grads, args = _grads([40, 9], True, T=100, S=130)
        want = tfa._flash_bwd_pair_reference(*args)
        for g, w in zip(grads, want):
            assert g.numpy().tobytes() == w.numpy().tobytes()
        # 64-row tiles and an uneven tail: the same function as the dense
        # plain backward, summed in another order
        for g, w in zip(grads, tfa._flash_bwd_reference(*args)):
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       atol=FLASH_BWD_TOL, rtol=0)

    @pytest.mark.parametrize("B,H,D,engine", [(64, 8, 64, "pair"),
                                              (16, 8, 64, "pair"),
                                              (8, 8, 64, "pair"),
                                              (4, 8, 64, "pair"),
                                              (20, 8, 64, "pair"),
                                              (24, 8, 64, "pair"),
                                              (28, 8, 64, "pair"),
                                              (32, 8, 64, "pair"),
                                              (48, 8, 64, "pair"),
                                              (24, 4, 128, "pair"),
                                              (28, 4, 128, "pair"),
                                              (32, 4, 128, "pair"),
                                              (64, 4, 128, "pair"),
                                              (128, 8, 64, "pair"),
                                              (64, 8, 32, "pair")])
    def test_auto_rule_at_the_sweep_shapes(self, B, H, D, engine):
        """The engines the rule picks at PERF.md's sweep shapes on a
        132-SM H100: bench.py's four Transformer shapes (B x T = 16,384
        tokens, H 8, D 64), B*H across and past B2's slots at D 64 and
        D 128, and D 32 — the pair at each since B3's redesign."""
        assert tfa._pick_bwd_engine(B, H, D, 132) == engine

    @pytest.mark.parametrize("D,blocks", [(32, 3), (64, 2), (128, 1)])
    def test_b2_blocks_per_sm_from_shared_memory(self, D, blocks):
        """bwd_smem<64> is 100,352 bytes: two to a 228 KB SM."""
        assert tfa._b2_blocks_per_sm(D) == blocks

    def test_alignment_copies_only_misaligned_tensors(self):
        """B3 and B5 stage rows with 16-byte copies: a view whose base or
        strides are not 16-byte multiples is copied to a fresh tensor; an
        aligned transposed view (as the Program feeds q/k/v) and an
        aligned contiguous tensor are passed as they are."""
        view = torch.zeros((2, 40, 3, 32)).transpose(1, 2)
        got, st = tfa._aligned16(view)
        assert got is view and st == list(view.stride()[:3])
        flat = torch.zeros(2 * 40 * 3 * 32 + 1)
        off = flat[1:].view(2, 40, 3, 32).transpose(1, 2)  # base + 4 bytes
        got, st = tfa._aligned16(off)
        assert got.data_ptr() != off.data_ptr() and got.data_ptr() % 16 == 0
        assert torch.equal(got, off) and st == list(got.stride()[:3])
        odd = torch.zeros((2, 3, 40, 33))[..., :32]  # time stride 132 bytes
        got, st = tfa._aligned16(odd)
        assert got.is_contiguous() and torch.equal(got, odd)
        assert st == [3 * 40 * 32, 40 * 32, 32]
        q = torch.zeros((5, 3, 32))  # a paged prefill chunk's queries
        assert tfa._aligned16(q)[0] is q
        pool = torch.zeros(4 * 16 * 3 * 32 + 2)[2:].view(4, 16, 3, 32)
        assert tfa._aligned16(pool)[0].data_ptr() % 16 == 0

    @pytest.mark.parametrize("misaligned", [None, "q", "k", "v"])
    def test_forward_wrapper_hands_the_kernel_aligned_rows(self, misaligned,
                                                           monkeypatch):
        """B1 stages q, k and v rows with 16-byte copies: the wrapper hands
        pt_flash_fwd an aligned copy of a misaligned tensor and the
        Program's aligned transposed views as they are (a stand-in
        library records the call; nothing is launched)."""
        from paddle_tpu_torch import cuda_kernels

        calls = []

        class Lib:
            def pt_flash_fwd(self, *args):
                calls.append(args)
                return 0

        monkeypatch.setattr(cuda_kernels, "load_library", Lib)
        monkeypatch.setattr(tfa, "_device_index", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: type("S", (), {
                                "cuda_stream": 0})())
        monkeypatch.setitem(tfa.KERNEL_LAUNCHES, "flash_attention_fwd", 0)
        B, H, T, S, D = 2, 3, 40, 24, 32

        def view(n, off):
            flat = torch.zeros(B * n * H * D + off)
            return flat[off:].view(B, n, H, D).transpose(1, 2)

        ins = {name: view(n, 1 if name == misaligned else 0)
               for name, n in (("q", T), ("k", S), ("v", S))}
        out, lse = tfa._flash_fwd_cuda(ins["q"], ins["k"], ins["v"], None,
                                       False, 0.2)
        assert out.shape == (B, H, T, D) and lse.shape == (B, H, T)
        (args,) = calls
        assert tfa.KERNEL_LAUNCHES["flash_attention_fwd"] == 1
        strides = {"q": args[11:14], "k": args[14:17], "v": args[17:20]}
        for i, name in enumerate(("q", "k", "v")):
            t = ins[name]
            assert args[i] % 16 == 0
            assert all(s * 4 % 16 == 0 for s in strides[name])
            if name == misaligned:
                assert args[i] != t.data_ptr()
                assert list(strides[name]) == [t.shape[1] * t.shape[2] * D,
                                               t.shape[2] * D, D]
            else:
                assert args[i] == t.data_ptr()
                assert list(strides[name]) == list(t.stride()[:3])

    def test_pair_wrapper_rejects_bad_inputs_before_launch(self):
        q, k, v, do = (torch.from_numpy(x) for x in _flash_case(4, 8, 8, D=32))
        lens = torch.tensor([8, 3], dtype=torch.int32)
        out, lse = tfa._flash_fwd_reference(q, k, v, lens, False, 0.2)
        bwd = tfa._flash_bwd_pair_cuda
        with pytest.raises(ValueError, match="head_dim"):
            bwd(q[..., :16], k[..., :16], v[..., :16], lens, out[..., :16],
                lse, do[..., :16], False, 0.2)
        with pytest.raises(TypeError, match="float32"):
            bwd(q, k.double(), v, lens, out, lse, do, False, 0.2)
        with pytest.raises(ValueError, match="kv_lens"):
            bwd(q, k, v, lens.long(), out, lse, do, False, 0.2)
        with pytest.raises(ValueError, match="lse"):
            bwd(q, k, v, lens, out, lse[:, :, :4].contiguous(), do, False,
                0.2)
        with pytest.raises(ValueError, match="match"):
            bwd(q, k[:1], v[:1], lens, out, lse, do, False, 0.2)
        with pytest.raises(ValueError, match="out/do"):
            bwd(q, k, v, lens, out[:, :, :4], lse, do, False, 0.2)

    @pytest.mark.parametrize("engine", ["auto", "fused", "pair"])
    def test_cpu_calls_count_no_launch(self, engine, monkeypatch):
        monkeypatch.setattr(tfa, "FLASH_BWD_IMPL", engine)
        before = dict(tfa.KERNEL_LAUNCHES)
        assert {"flash_attention_bwd_dkv", "flash_attention_bwd_dq"} <= set(
            before)
        _grads([40, 0], False)
        assert tfa.KERNEL_LAUNCHES == before
