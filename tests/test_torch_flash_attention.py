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


LOG2E = 1.4426950408889634


def _paged_split_reference(q, k_pool, v_pool, page_tables, kv_lens,
                           sm_scale):
    """A float32 model of B4's partition and merge (the CUDA kernel in
    paddle_tpu_torch/csrc/paged_attention.cu): slot s sees its first
    min(kv_lens[s], mp * ps) keys, cut into splits of
    ``_b4_split_pages(ps)`` whole pages; each split scores its keys with q
    scaled into log2 units, takes one max m and one sum l of 2^(s - m) and
    acc = sum 2^(s - m) v; the merge weighs each live split by 2^(m - M)
    in split order and divides by max(L, 1e-30).  A slot with no visible
    key gets exact zeros.  Each (slot, split) is computed from that slot's
    q, kv_lens and pages alone, as each kernel block is."""
    S, H, Dh = q.shape
    ps, mp = k_pool.shape[1], page_tables.shape[1]
    sk = tfa._b4_split_pages(ps) * ps
    ql = q.float() * torch.tensor(sm_scale, dtype=torch.float32) * LOG2E
    out = torch.zeros((S, H, Dh), dtype=torch.float32)
    for s in range(S):
        kend = min(int(kv_lens[s]), mp * ps)
        recs = []
        for k0 in range(0, max(kend, 0), sk):
            keys = torch.arange(k0, min(k0 + sk, kend))
            pages = page_tables[s, keys // ps].long()
            k = k_pool[pages, keys % ps].float()          # [n, H, Dh]
            v = v_pool[pages, keys % ps].float()
            sc = (ql[s][None] * k).sum(-1)                 # [n, H]
            m = sc.amax(0)
            p = torch.exp2(sc - m)
            recs.append((m, p.sum(0), (p[..., None] * v).sum(0)))
        if not recs:
            continue
        big = torch.stack([m for m, _, _ in recs]).amax(0)
        lsum = torch.zeros(H)
        acc = torch.zeros(H, Dh)
        for m, l, a in recs:
            w = torch.exp2(m - big)
            lsum = lsum + l * w
            acc = acc + a * w[:, None]
        out[s] = acc / lsum.clamp_min(1e-30)[:, None]
    return out


# B4's split at the tests' page size 16: 16 pages, 256 keys; a 20-page
# table holds 320 keys, so a slot has up to two splits, the second partial
B4_PS, B4_MP = 16, 20
B4_SPLIT = 256
# kv_lens at 1, ps, a split's size - 1, size and size + 1, the table's
# width mp * ps, and past it (the walk stops at mp * ps)
B4_EDGE_LENS = [1, B4_PS, B4_SPLIT - 1, B4_SPLIT, B4_SPLIT + 1,
                B4_MP * B4_PS, B4_MP * B4_PS + 5]


def _b4_case(seed, lens, P=48, H=2, Dh=16):
    return _decode_case(seed, lens, P=P, ps=B4_PS, H=H, Dh=Dh, mp=B4_MP)


def _split_model(q, kp, vp, tables, lens, dtype="float32"):
    td = DTYPES[dtype][1]
    return _paged_split_reference(
        torch.from_numpy(q), torch.from_numpy(kp).to(td),
        torch.from_numpy(vp).to(td), torch.from_numpy(tables),
        torch.from_numpy(lens), 1.0 / np.sqrt(q.shape[-1])).numpy()


class TestPagedDecodeSplit:
    """B4's design (splits of whole pages, a fixed-order merge, the walk
    clamped at the table's width) on the CPU: its torch model against the
    JAX package, and the contracts the kernel is held to on the card.
    Tolerance against JAX: TOL (2e-6 absolute; the model sums in splits
    and in log2 units, O(1) values)."""

    def test_split_constant_matches_the_kernel_source(self):
        import os
        import re
        src = open(os.path.join(
            os.path.dirname(tfa.__file__), os.pardir, "csrc",
            "paged_attention.cu")).read()
        (keys,) = re.findall(r"constexpr int kSplitKeys = (\d+);", src)
        assert int(keys) == tfa._B4_SPLIT_KEYS == B4_SPLIT
        assert tfa._b4_split_pages(B4_PS) * B4_PS == B4_SPLIT

    @pytest.mark.parametrize("ps,pages", [(1, 256), (3, 85), (16, 16),
                                          (17, 15), (32, 8)])
    def test_split_is_whole_pages_of_at_most_the_split_keys(self, ps, pages):
        assert tfa._b4_split_pages(ps) == pages
        assert pages * ps <= B4_SPLIT < (pages + 1) * ps

    def test_workspace_shape_from_the_shapes_alone(self):
        # the serving width: 8 slots, 8 heads, mp 128, ps 16, Dh 64
        assert tfa._b4_workspace_shape(8, 8, 128, 16, 64) == (8, 8, 8, 66)
        assert tfa._b4_workspace_shape(1, 4, 128, 3, 128) == (1, 4, 2, 130)
        assert tfa._b4_workspace_shape(2, 1, 5, 16, 32) == (2, 1, 1, 34)

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("engine", ENGINES)
    def test_split_model_matches_jax_at_the_edge_lengths(self, engine, dtype):
        q, kp, vp, tables, lens = _b4_case(10, B4_EDGE_LENS)
        want = _jax_decode(q, kp, vp, tables, lens, dtype, **engine)
        got = _split_model(q, kp, vp, tables, lens, dtype)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("engine", ENGINES)
    def test_plain_version_matches_jax_past_the_table(self, engine, dtype):
        """kv_len = mp * ps + 5: every engine attends to the table's
        mp * ps keys (the kernel clamps its walk there)."""
        lens = [B4_MP * B4_PS + 5, B4_MP * B4_PS, 7]
        q, kp, vp, tables, lens = _b4_case(11, lens)
        want = _jax_decode(q, kp, vp, tables, lens, dtype, **engine)
        got = _port_decode(q, kp, vp, tables, lens, dtype)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        assert got[0].tobytes() == _port_decode(
            q, kp, vp, tables, np.full_like(lens, B4_MP * B4_PS),
            dtype)[0].tobytes()

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_split_model_slot_alone_equals_batched(self, dtype):
        q, kp, vp, tables, lens = _b4_case(12, B4_EDGE_LENS)
        batched = _split_model(q, kp, vp, tables, lens, dtype)
        for s in range(len(lens)):
            one = slice(s, s + 1)
            alone = _split_model(q[one], kp, vp, tables[one], lens[one],
                                 dtype)
            assert alone.tobytes() == batched[one].tobytes()

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_split_model_page_permutation_is_bitwise_inert(self, dtype):
        q, kp, vp, tables, lens = _b4_case(13, B4_EDGE_LENS)
        P = kp.shape[0]
        perm = np.concatenate([[0], np.random.RandomState(14).permutation(
            np.arange(1, P))])
        inv = np.argsort(perm).astype(np.int32)
        a = _split_model(q, kp, vp, tables, lens, dtype)
        b = _split_model(q, kp[perm], vp[perm], inv[tables], lens, dtype)
        assert a.tobytes() == b.tobytes()

    def test_split_model_kv_lens_zero_is_exact_zeros(self):
        q, kp, vp, tables, lens = _b4_case(15, [0, 300, 0, 1])
        got = _split_model(q, kp, vp, tables, lens)
        assert (got[0] == 0).all() and (got[2] == 0).all()
        assert np.abs(got[1]).sum() > 0 and np.abs(got[3]).sum() > 0

    @pytest.mark.parametrize("misaligned", [None, "q", "k_pool", "v_pool"])
    def test_wrapper_one_call_a_workspace_and_no_read_of_kv_lens(
            self, misaligned, monkeypatch):
        """B4's wrapper makes one pt_paged_decode call and counts one
        launch; it hands the kernel a float32 workspace of
        _b4_workspace_shape(...) and 16-byte aligned q and pools (an
        aligned copy of a misaligned one), and it reads no value of
        kv_lens on the host (a stand-in library records the call;
        nothing is launched)."""
        from paddle_tpu_torch import cuda_kernels

        calls = []

        class Lib:
            def pt_paged_decode(self, *args):
                calls.append(args)
                return 0

        made = {}
        real_empty = torch.empty

        def empty(*args, **kwargs):  # every tensor the wrapper allocates
            t = real_empty(*args, **kwargs)
            made[t.data_ptr()] = t
            return t

        def no_host_read(*args, **kwargs):
            raise AssertionError("the wrapper read a tensor on the host")

        monkeypatch.setattr(cuda_kernels, "load_library", Lib)
        monkeypatch.setattr(tfa, "_device_index", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: type("S", (), {
                                "cuda_stream": 0})())
        monkeypatch.setitem(tfa.KERNEL_LAUNCHES, "paged_decode_attention", 0)
        S, H, Dh, P, ps, mp = 3, 2, 32, 9, 16, 40

        def tensor(shape, off):
            flat = real_empty(int(np.prod(shape)) + off).normal_()
            return flat[off:].view(shape)

        ins = {name: tensor(shape, 1 if name == misaligned else 0)
               for name, shape in (("q", (S, H, Dh)),
                                   ("k_pool", (P, ps, H, Dh)),
                                   ("v_pool", (P, ps, H, Dh)))}
        tables = torch.randint(0, P, (S, mp), dtype=torch.int32)
        lens = torch.tensor([5, 0, 600], dtype=torch.int32)
        with monkeypatch.context() as m:
            m.setattr(torch, "empty", empty)
            for attr in ("item", "tolist", "cpu", "numpy"):
                m.setattr(torch.Tensor, attr, no_host_read)
            out = tfa._paged_decode_cuda(ins["q"], ins["k_pool"],
                                         ins["v_pool"], tables, lens, 0.25)
        (args,) = calls
        assert tfa.KERNEL_LAUNCHES["paged_decode_attention"] == 1
        assert args[3:6] == (tables.data_ptr(), lens.data_ptr(),
                             out.data_ptr())
        ws = made[args[6]]
        assert ws.dtype == torch.float32
        assert tuple(ws.shape) == tfa._b4_workspace_shape(S, H, mp, ps, Dh) \
            == (S, H, 3, Dh + 2)
        assert args[7:13] == (3, S, H, Dh, ps, mp)
        assert args[13] == 0.25 and args[14] == 0
        assert tuple(out.shape) == (S, H, Dh) and out.dtype == torch.float32
        for i, name in enumerate(("q", "k_pool", "v_pool")):
            assert args[i] % 16 == 0
            if name == misaligned:
                assert args[i] != ins[name].data_ptr()
            else:
                assert args[i] == ins[name].data_ptr()


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

    @pytest.mark.parametrize("B,H,D,engine", [(64, 8, 64, "fused"),
                                              (16, 8, 64, "fused"),
                                              (8, 8, 64, "fused"),
                                              (4, 8, 64, "fused"),
                                              (20, 8, 64, "fused"),
                                              (24, 8, 64, "fused"),
                                              (28, 8, 64, "fused"),
                                              (32, 8, 64, "fused"),
                                              (48, 8, 64, "fused"),
                                              (24, 4, 128, "fused"),
                                              (28, 4, 128, "fused"),
                                              (32, 4, 128, "fused"),
                                              (64, 4, 128, "fused"),
                                              (128, 8, 64, "fused"),
                                              (64, 8, 32, "fused")])
    def test_auto_rule_at_the_sweep_shapes(self, B, H, D, engine):
        """The engines the rule picks at PERF.md's sweep shapes on a
        132-SM H100: bench.py's four Transformer shapes (B x T = 16,384
        tokens, H 8, D 64), B*H across and past the former B2's slots at
        D 64 and D 128, and D 32 — the fused engine at each since B2's
        redesign (it was the pair at each after B3's)."""
        assert tfa._pick_bwd_engine(B, H, D, 132) == engine

    @pytest.mark.parametrize("D,blocks", [(32, 3), (64, 2), (128, 1)])
    def test_b2_blocks_per_sm_from_shared_memory(self, D, blocks):
        """B2's blocks are B3's dk/dv blocks: dkv_smem<64> is 107,008
        bytes, two to a 228 KB SM (74,240 at D 32, three; 172,544 at
        D 128, one)."""
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

    @pytest.mark.parametrize("misaligned", [None, "q", "k", "v", "do"])
    def test_fused_wrapper_hands_the_kernel_aligned_rows_and_a_workspace(
            self, misaligned, monkeypatch):
        """B2 stages q, k, v and do rows with 16-byte copies and writes its
        dq partials into a float32 workspace: the wrapper hands
        pt_flash_bwd an aligned copy of a misaligned tensor (the Program's
        aligned transposed views as they are), a [B*H, ceil(S/64), T, D]
        float32 workspace and a [B, H, T] delta, and counts one launch a
        call; with no (query, key) pair it returns zero gradients without
        a launch (a stand-in library records the call; nothing is
        launched)."""
        from paddle_tpu_torch import cuda_kernels

        calls = []

        class Lib:
            def pt_flash_bwd(self, *args):
                calls.append(args)
                return 0

        made = {}
        real_empty = torch.empty

        def empty(*args, **kwargs):  # every tensor the wrapper allocates
            t = real_empty(*args, **kwargs)
            made[t.data_ptr()] = t
            return t

        monkeypatch.setattr(cuda_kernels, "load_library", Lib)
        monkeypatch.setattr(tfa, "_device_index", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: type("S", (), {
                                "cuda_stream": 0})())
        monkeypatch.setattr(torch, "empty", empty)
        monkeypatch.setitem(tfa.KERNEL_LAUNCHES, "flash_attention_bwd", 0)
        B, H, T, S, D = 2, 3, 40, 130, 32

        def view(n, off):
            flat = real_empty(B * n * H * D + off).zero_()
            return flat[off:].view(B, n, H, D).transpose(1, 2)

        ins = {name: view(n, 1 if name == misaligned else 0)
               for name, n in (("q", T), ("k", S), ("v", S), ("do", T))}
        out, lse = view(T, 0), torch.zeros((B, H, T))
        dq, dk, dv = tfa._flash_bwd_cuda(ins["q"], ins["k"], ins["v"], None,
                                         out, lse, ins["do"], False, 0.2)
        (args,) = calls
        assert tfa.KERNEL_LAUNCHES["flash_attention_bwd"] == 1
        assert args[12:17] == (B, H, T, S, D)
        assert [args[i] for i in (7, 8, 9)] == [
            g.data_ptr() for g in (dq, dk, dv)]
        ws, delta = made[args[10]], made[args[11]]
        assert ws.dtype == delta.dtype == torch.float32
        assert tuple(ws.shape) == (B * H, 3, T, D) == \
            tfa._b2_workspace_shape(B, H, T, S, D)
        assert tuple(delta.shape) == (B, H, T)
        strides = {"q": args[17:20], "k": args[20:23], "v": args[23:26],
                   "do": args[29:32]}
        for i, name in ((0, "q"), (1, "k"), (2, "v"), (4, "do")):
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
        # no (query, key) pair: zero gradients, nothing launched
        for t_len, s_len in ((0, S), (T, 0)):
            g = tfa._flash_bwd_cuda(
                ins["q"][:, :, :t_len], ins["k"][:, :, :s_len],
                ins["v"][:, :, :s_len], None, out[:, :, :t_len],
                lse[:, :, :t_len].contiguous(), ins["do"][:, :, :t_len],
                True, 0.2)
            assert [tuple(x.shape) for x in g] == [
                (B, H, t_len, D), (B, H, s_len, D), (B, H, s_len, D)]
            assert all((x == 0).all() for x in g)
        assert len(calls) == 1
        assert tfa.KERNEL_LAUNCHES["flash_attention_bwd"] == 1

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
