"""Training the Transformer through the port's Executor against the JAX
package's, on the CPU, at a small size (2 layers, d_model 32, 2 heads,
d_inner 64, vocab 60, batch 2, 16 tokens with pad tails).

Both packages build the Program from the same layer functions; the JAX
startup state is copied into the port with ``load_numpy_state`` and
dropout is off, so three Adam steps on the same seeded feeds must agree:
losses to 1e-5 relative, every step-1 ``<param>@GRAD`` to
1e-5 * max(1, max|g|) (the packages sum in different orders).  The JAX
package's flash attention runs its Pallas kernels in interpret mode.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT

SMALL = dict(batch_size=2, seq_len=16, src_vocab_size=60, trg_vocab_size=60,
             max_length=16, n_layer=2, n_head=2, d_model=32, d_inner=64,
             dropout=0.0)
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5


def _feeds(seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        f = {n: rng.randint(3, 60, size=(2, 16)).astype("int64")
             for n in ("src_word", "trg_word", "lbl_word")}
        f["src_word"][0, 12:] = 0
        f["src_word"][1, 5:] = 0
        f["trg_word"][0, 10:] = 0
        f["lbl_word"][0, 10:] = 0
        out.append(f)
    return out


@pytest.fixture(scope="module", params=[True, False], ids=["flash", "plain"])
def runs(request):
    """Losses of STEPS Adam steps and the step-1 gradients, from both
    packages, for one use_flash setting."""
    use_flash = request.param
    with jfluid.unique_name.guard():
        jm = JT.get_model(use_flash=use_flash, **SMALL)
    with tfluid.unique_name.guard():
        tm = TT.get_model(use_flash=use_flash, **SMALL)
    grads = [p.name + "@GRAD" for p in jm["main"].global_block().all_parameters()
             if p.trainable]
    feeds = _feeds(1)
    out = {"grad_names": grads}
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jm["startup"])
        state = {n: np.asarray(jscope[n]) for n in jm["main"].persistable_names()
                 if n in jscope}
        # one fetch list for every step: one compile
        res = [exe.run(jm["main"], feed=f, fetch_list=[jm["loss"]] + grads)
               for f in feeds]
    out["jax"] = ([float(np.ravel(r[0])[0]) for r in res], res[0][1:])
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tm["startup"])
        tfluid.load_numpy_state(tm["main"], state, device="cpu")
        res = [exe.run(tm["main"], feed=f,
                       fetch_list=[tm["loss"]] + (grads if i == 0 else []))
               for i, f in enumerate(feeds)]
    out["port"] = ([float(np.ravel(r[0])[0]) for r in res], res[0][1:])
    return out


def test_losses_match_jax_over_adam_steps(runs):
    want, got = runs["jax"][0], runs["port"][0]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert got[0] != got[1] != got[2]  # the steps moved the parameters


def test_step1_gradients_match_jax(runs):
    assert len(runs["grad_names"]) > 0
    for name, g, w in zip(runs["grad_names"], runs["port"][1], runs["jax"][1]):
        assert g.shape == w.shape, name
        tol = GRAD_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def _dropout_program(p, n):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 3
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[n], dtype="float32",
                               append_batch_size=False)
        y = tfluid.layers.dropout(x, dropout_prob=p)
    return main, y


def test_dropout_downgrade_in_infer_semantics():
    """The JAX rule's semantics: in training kept values pass unscaled and
    dropped ones are 0, with a keep rate within 1% of 1 - p; at test time
    every value is scaled by 1 - p.  Draws are seeded by the Program seed
    and the run, and differ between runs."""
    p, n = 0.3, 1 << 20
    main, y = _dropout_program(p, n)
    x = np.random.RandomState(0).uniform(1.0, 2.0, n).astype(np.float32)
    exe = tfluid.Executor(tfluid.CPUPlace())
    outs = []
    for _ in range(2):
        scope = tfluid.Scope()
        outs.append([exe.run(main, feed={"x": x}, fetch_list=[y], scope=scope)[0]
                     for _ in range(2)])
    first = outs[0][0]
    kept = first != 0
    np.testing.assert_array_equal(first[kept], x[kept])
    assert abs(kept.mean() / (1 - p) - 1) < 0.01
    assert outs[0][0].tobytes() == outs[1][0].tobytes()   # same seed, same run
    assert outs[0][0].tobytes() != outs[0][1].tobytes()   # next run, new mask
    test = main.clone(for_test=True)
    (inf,) = exe.run(test, feed={"x": x}, fetch_list=[y.name],
                     scope=tfluid.Scope())
    np.testing.assert_array_equal(inf, x * np.float32(1 - p))


def test_backward_binds_zero_grad_for_unreached_param():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        used = tfluid.layers.fc(x, size=3, bias_attr=False)
        tfluid.layers.create_parameter([5], "float32", name="unused")
        loss = tfluid.layers.reduce_sum(used)
        tfluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        before = scope["unused"].clone()
        g_used, g_unused = exe.run(
            main, feed={"x": np.ones((2, 4), np.float32)},
            fetch_list=[used.block.program.global_block().all_parameters()[0].name
                        + "@GRAD", "unused@GRAD"])
    np.testing.assert_array_equal(g_unused, np.zeros(5, np.float32))
    np.testing.assert_allclose(g_used, np.full((4, 3), 2.0, np.float32))
    assert torch.equal(scope["unused"], before)
