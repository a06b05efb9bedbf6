"""The port's decode LM (paddle_tpu_torch.models.transformer) held
against the JAX package's on the CPU.

Both packages get the same ``lm_params`` arrays (the port's copy of the
numpy initialiser must give them bit for bit) and the same token, page
and pool inputs.  Logits and pool contents are compared at rtol/atol
1e-5: float32 end to end, but XLA's and MKL's matmuls sum in different
orders, so the last bits differ and grow through two layers.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT

RTOL = ATOL = 1e-5
DIMS = dict(vocab_size=50, n_layer=2, n_head=2, d_model=32, d_inner=64,
            max_length=128)
PS, MP, P = 8, 8, 24   # page size, pages per sequence, pool pages


@pytest.fixture(scope="module")
def model():
    params, meta = JT.lm_params(seed=7, **DIMS)
    return params, meta, TT.params_from_numpy(params, "cpu", meta=meta)


def _pools(seed):
    """Random (not zero) pools, so pages the steps leave alone are
    compared too."""
    rng = np.random.RandomState(seed)
    shape = (DIMS["n_layer"], P, PS, DIMS["n_head"],
             DIMS["d_model"] // DIMS["n_head"])
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _jax_chunk(params, meta, tokens, start, valid, kp, vp, chunk_pages,
               gather_pages):
    logits, kp, vp = JT.lm_prefill_chunk(
        params, jnp.asarray(tokens), jnp.int32(start), jnp.int32(valid),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(chunk_pages),
        jnp.asarray(gather_pages), n_head=meta["n_head"])
    return np.asarray(logits), np.asarray(kp), np.asarray(vp)


def _port_chunk(lm, tokens, start, valid, kp, vp, chunk_pages, gather_pages):
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.no_grad():
        logits = TT.lm_prefill_chunk(
            lm, torch.from_numpy(tokens), start, valid, kt, vt,
            torch.from_numpy(chunk_pages), torch.from_numpy(gather_pages))
    return logits.numpy(), kt.numpy(), vt.numpy()


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_lm_params_bit_equal_to_jax():
    a, meta_a = JT.lm_params(seed=3, **DIMS)
    b, meta_b = TT.lm_params(seed=3, **DIMS)
    assert meta_a == meta_b
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_params_from_numpy_copies_every_weight(model):
    params, meta, lm = model
    assert lm.n_head == meta["n_head"] and lm.device.type == "cpu"
    np.testing.assert_array_equal(lm.tok_emb.numpy(), params["tok_emb"])
    for lp, tp in zip(params["layers"], lm.layers):
        for key, arr in lp.items():
            np.testing.assert_array_equal(getattr(tp, key).numpy(), arr)
    assert not any(p.requires_grad for p in lm.parameters())


# (prompt length, chunk width): one bucket-wide chunk, and a prompt that
# ends part-way through its last page
@pytest.mark.parametrize("n,C", [(13, 16), (16, 16), (5, 8)])
def test_prefill_chunk_matches_jax(model, n, C):
    params, meta, lm = model
    rng = np.random.RandomState(n)
    tokens = np.zeros(C, np.int32)
    tokens[:n] = rng.randint(1, DIMS["vocab_size"], size=n)
    table = np.zeros(MP, np.int32)
    table[:3] = [5, 2, 9]
    chunk = np.zeros(C // PS, np.int32)
    chunk[:-(-n // PS)] = table[:-(-n // PS)]
    kp, vp = _pools(n)
    want = _jax_chunk(params, meta, tokens, 0, n, kp, vp, chunk, table)
    got = _port_chunk(lm, tokens, 0, n, kp, vp, chunk, table)
    for g, w in zip(got, want):
        _assert_close(g, w)


# (prompt length, bucket): a prompt that ends part-way through its last
# page, one that fills its bucket, a one-token prompt
@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("n,T", [(13, 16), (16, 16), (1, 8)])
def test_lm_prefill_matches_jax(model, use_flash, n, T):
    params, meta, lm = model
    rng = np.random.RandomState(n)
    tokens = np.zeros(T, np.int32)
    tokens[:n] = rng.randint(1, DIMS["vocab_size"], size=n)
    want = JT.lm_prefill(params, jnp.asarray(tokens), jnp.int32(n),
                         n_head=meta["n_head"], use_flash=use_flash)
    with torch.no_grad():
        got = TT.lm_prefill(lm, torch.from_numpy(tokens), n,
                            use_flash=use_flash)
    assert got[1].shape == (DIMS["n_layer"], T, DIMS["n_head"], 16)
    for g, w in zip(got, want):
        _assert_close(g.numpy(), np.asarray(w))


def test_write_prompt_kv_matches_jax():
    from paddle_tpu.serving import kv_cache as JK
    from paddle_tpu_torch.serving import kv_cache as TK

    kp, vp = _pools(8)
    rng = np.random.RandomState(9)
    L, H, D = DIMS["n_layer"], DIMS["n_head"], 16
    k_new = rng.randn(L, 4 * PS, H, D).astype(np.float32)
    v_new = rng.randn(L, 4 * PS, H, D).astype(np.float32)
    pages = np.array([5, 2, 0, 0], np.int32)   # two live pages, two scratch
    jk, jv = JK.write_prompt_kv(jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(k_new), jnp.asarray(v_new),
                                jnp.asarray(pages))
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    TK.write_prompt_kv(kt, vt, torch.from_numpy(k_new), torch.from_numpy(v_new),
                       torch.from_numpy(pages))
    # every page but the scratch page, whose colliding writes land in an
    # unspecified order
    np.testing.assert_array_equal(kt.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(vt.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    np.testing.assert_array_equal(kt.numpy()[:, 2], k_new[:, PS:2 * PS])


def test_chunked_prefill_matches_jax_and_itself(model):
    # 20 tokens in three 8-wide chunks == JAX's three chunks, and == one
    # 32-wide chunk bitwise on the port
    params, meta, lm = model
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, DIMS["vocab_size"], size=20).astype(np.int32)
    table = np.zeros(MP, np.int32)
    table[:4] = [3, 7, 1, 11]
    kp0, vp0 = _pools(2)
    jk, jv = kp0, vp0
    pk, pv = kp0, vp0
    for start in (0, 8, 16):
        valid = min(8, 20 - start)
        toks = np.zeros(8, np.int32)
        toks[:valid] = prompt[start:start + valid]
        chunk = table[start // PS:start // PS + 1].copy()
        jl, jk, jv = _jax_chunk(params, meta, toks, start, valid, jk, jv,
                                chunk, table)
        pl, pk, pv = _port_chunk(lm, toks, start, valid, pk, pv, chunk,
                                 table)
        _assert_close(pl, jl)
    _assert_close(pk, jk)
    _assert_close(pv, jv)
    toks = np.zeros(32, np.int32)
    toks[:20] = prompt
    mono = _port_chunk(lm, toks, 0, 20, kp0, vp0,
                       np.array([3, 7, 1, 0], np.int32), table)
    assert mono[0].tobytes() == pl.tobytes()
    # every page holding the prompt's 20 positions is bitwise the same
    for page in (3, 7):
        assert mono[1][:, page].tobytes() == pk[:, page].tobytes()
    assert mono[1][:, 1, :4].tobytes() == pk[:, 1, :4].tobytes()


def _decode_inputs():
    # slots 0 and 2 decode (positions 9 and 3), slots 1 and 3 inactive
    tables = np.zeros((4, MP), np.int32)
    tables[0, :2] = [4, 6]
    tables[2, :1] = [10]
    tokens = np.array([7, 0, 33, 0], np.int32)
    positions = np.array([9, 0, 3, 0], np.int32)
    kv_lens = np.array([10, 0, 4, 0], np.int32)
    return tokens, positions, tables, kv_lens


def test_decode_step_matches_jax(model):
    params, meta, lm = model
    tokens, positions, tables, kv_lens = _decode_inputs()
    kp, vp = _pools(3)
    jl, jk, jv = JT.lm_decode_step(
        params, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables), jnp.asarray(kv_lens),
        n_head=meta["n_head"])
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.no_grad():
        tl = TT.lm_decode_step(lm, torch.from_numpy(tokens),
                               torch.from_numpy(positions), kt, vt,
                               torch.from_numpy(tables),
                               torch.from_numpy(kv_lens))
    active = kv_lens > 0
    _assert_close(tl.numpy()[active], np.asarray(jl)[active])
    # every page but the scratch page 0 (inactive slots' colliding
    # writes land there in an undefined order)
    _assert_close(kt.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    _assert_close(vt.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    # the active slots' new k landed at (page, offset) in place
    assert not np.array_equal(kt.numpy()[:, 6, 1], kp[:, 6, 1])
    np.testing.assert_array_equal(kt.numpy()[:, 6, 2:], kp[:, 6, 2:])


def test_decode_rows_are_batch_independent(model):
    # a slot's logits are the same bits whatever its neighbours do
    _, _, lm = model
    tokens, positions, tables, kv_lens = _decode_inputs()
    kp, vp = _pools(4)

    def run(tok, pos, tab, lens):
        kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        with torch.no_grad():
            return TT.lm_decode_step(
                lm, torch.from_numpy(tok), torch.from_numpy(pos), kt, vt,
                torch.from_numpy(tab), torch.from_numpy(lens)).numpy()

    full = run(tokens, positions, tables, kv_lens)
    only0 = [a.copy() for a in (tokens, positions, tables, kv_lens)]
    for a in only0:
        a[1:] = 0      # every other slot inactive
    alone = run(*only0)
    assert full[0].tobytes() == alone[0].tobytes()


def test_out_of_range_token_ids_follow_jax(model):
    # JAX's gather wraps a negative id once, then clamps; the port does
    # the same instead of faulting (a device assert on the card)
    params, meta, lm = model
    V = DIMS["vocab_size"]
    tokens = np.array([-1, V + 5, -3 * V, 2 ** 30], np.int32)
    _, positions, tables, kv_lens = _decode_inputs()
    kv_lens = np.array([10, 1, 4, 2], np.int32)
    positions = kv_lens - 1
    tables[1, 0], tables[3, 0] = 12, 13
    kp, vp = _pools(5)
    jl, _, _ = JT.lm_decode_step(
        params, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables), jnp.asarray(kv_lens),
        n_head=meta["n_head"])
    with torch.no_grad():
        tl = TT.lm_decode_step(
            lm, torch.from_numpy(tokens), torch.from_numpy(positions),
            torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
            torch.from_numpy(tables), torch.from_numpy(kv_lens))
    _assert_close(tl.numpy(), np.asarray(jl))


def test_bf16_pools_match_jax(model):
    params, meta, lm = model
    tokens, positions, tables, kv_lens = _decode_inputs()
    kp, vp = _pools(6)
    jl, jk, _ = JT.lm_decode_step(
        params, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16),
        jnp.asarray(tables), jnp.asarray(kv_lens), n_head=meta["n_head"])
    kt = torch.from_numpy(kp).to(torch.bfloat16)
    vt = torch.from_numpy(vp).to(torch.bfloat16)
    with torch.no_grad():
        tl = TT.lm_decode_step(lm, torch.from_numpy(tokens),
                               torch.from_numpy(positions), kt, vt,
                               torch.from_numpy(tables),
                               torch.from_numpy(kv_lens))
    active = kv_lens > 0
    # bf16 rounding of a freshly written k/v can differ by one ulp when
    # the f32 values differ in their last bits: compare at bf16's grain
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(kt.float().numpy()[:, 1:],
                               np.asarray(jk, np.float32)[:, 1:],
                               rtol=1e-2, atol=1e-2)


def test_legacy_prefill_matches_chunked_prefill(model):
    # one prompt through the whole-prompt prefill and through one
    # bucket-wide chunk: the same first-token logits (different attention
    # engines, so within 1e-5) and the same k/v in the prompt's pages
    _, _, lm = model
    rng = np.random.RandomState(4)
    n, T = 21, 32
    tokens = np.zeros(T, np.int32)
    tokens[:n] = rng.randint(1, DIMS["vocab_size"], size=n)
    table = np.zeros(MP, np.int32)
    table[:3] = [6, 3, 8]
    kp, vp = _pools(10)
    chunk = _port_chunk(lm, tokens, 0, n, kp, vp, table[:4].copy(), table)
    for use_flash in (True, False):
        with torch.no_grad():
            logits, k, v = TT.lm_prefill(lm, torch.from_numpy(tokens), n,
                                         use_flash=use_flash)
        _assert_close(logits.numpy(), chunk[0])
        for pos in range(n):
            page, off = table[pos // PS], pos % PS
            _assert_close(k.numpy()[:, pos], chunk[1][:, page, off])
            _assert_close(v.numpy()[:, pos], chunk[2][:, page, off])


def test_build_decode_model_on_cpu(model):
    params, meta, lm = model
    dm = TT.build_decode_model(params, meta, eos_id=3, device="cpu")
    assert dm.prefill_fn is not None and dm.prefill_chunk_fn is not None
    legacy = TT.build_decode_model(params, meta, device="cpu", chunked=False)
    assert legacy.prefill_fn is not None and legacy.prefill_chunk_fn is None
    assert dm.device.type == "cpu" and dm.eos_id == 3
    assert (dm.num_layers, dm.num_heads, dm.head_dim, dm.vocab_size) == (
        2, 2, 16, 50)
    # an already-built TransformerLM is taken as is
    assert TT.build_decode_model(lm, meta, device="cpu").device.type == "cpu"
