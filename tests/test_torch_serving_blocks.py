"""ROADMAP F-6 on both predict backends, on the CPU: each serving ``mul``
runs as ``ops.math_ops.blocked_matmul``, its rows padded to whole blocks
of ``SERVING_BLOCK_ROWS`` rows in one batched product, and the serving
export calls that same function, as an operator, at every batch.

- ``blocked_matmul`` gives the plain product's values (float32 sums in
  another order: 1e-5 relative), every row's bits whatever rows sit
  around it (one block shape), and no padding op where the rows fill
  two or more whole blocks;
- the small flash Transformer (2+2 layers, d_model 64, 16 tokens a
  sample) and the test MLP (8 -> 16 -> 4, one row a sample) are saved
  with ``aot=True``: every ``mul`` of the exported graph is the operator
  ``paddle_tpu_torch::blocked_mm`` over a symbolic number of rows, and
  the graph holds no other product of the activations;
- the artifact gives the serving Program backend's bits at batches
  within one block and across blocks;
- a request's rows come out with the same bits alone and inside larger
  batches on both backends (on the card chip_smoke holds the same at
  buckets 4, 8 and 16 for both models);
- ``f32_bf16_reduction`` restores the caller's cuBLAS setting after
  overlapping runs from two threads.
"""
import threading
from io import BytesIO

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import core
from paddle_tpu_torch.executor import SERVING_BLOCK_ROWS
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.ops.math_ops import blocked_matmul

SMALL = dict(batch_size=2, seq_len=16, src_vocab_size=500,
             trg_vocab_size=500, max_length=16, n_layer=2, n_head=2,
             d_model=64, d_inner=128, dropout=0.1, use_flash=True)
ROWS_PER_BLOCK = SERVING_BLOCK_ROWS // 16   # the Transformer's samples


def _feed(rows, seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, 500, size=(rows, 16)).astype("int64")
    trg = rng.randint(3, 500, size=(rows, 16)).astype("int64")
    src[0, 9:] = 0
    trg[-1, 4:] = 0
    return {"src_word": src, "trg_word": trg}


def _mlp_feed(rows, seed):
    return {"x": np.random.RandomState(seed).randn(rows, 8).astype("float32")}


def _save_transformer(d):
    with tfluid.unique_name.guard():
        m = TT.get_model(**SMALL)
    m["startup"].random_seed = 11
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(m["startup"])
        tfluid.io.save_inference_model(d, ["src_word", "trg_word"],
                                       [m["predict"]], exe,
                                       main_program=m["test"], aot=True)
    return sum(op.type == "mul" for op in m["test"].global_block().ops)


def _save_mlp(d):
    main, startup = tfluid.Program(), tfluid.Program()
    startup.random_seed = 17
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
        h = tfluid.layers.fc(x, size=16, act="relu")
        out = tfluid.layers.fc(h, size=4, act="softmax")
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        tfluid.io.save_inference_model(d, ["x"], [out], exe,
                                       main_program=main, aot=True)
    return sum(op.type == "mul" for op in main.global_block().ops)


MODELS = {"transformer": (_save_transformer, _feed),
          "mlp": (_save_mlp, _mlp_feed)}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("blocks")
    return {name: (str(root / name), save(str(root / name)))
            for name, (save, _) in MODELS.items()}


def _program_backend(d):
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.block_rows = SERVING_BLOCK_ROWS
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        prog, _, fetch = tfluid.io.load_inference_model(d, exe)

    def run(feed):
        return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)[0]
    return run


def _aot_backend(d):
    predict, _, _ = tfluid.io.load_aot_inference_model(d, device="cpu")
    return lambda feed: predict(feed)[0]


@pytest.mark.parametrize("rows", [1, 37, 256, 300])
def test_blocked_matmul_is_the_product(rows):
    g = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, 48), generator=g)
    y = torch.randn((48, 24), generator=g)
    got = blocked_matmul(x, y, SERVING_BLOCK_ROWS)
    assert got.shape == (rows, 24)
    torch.testing.assert_close(got, x @ y, rtol=1e-5, atol=1e-5)


def test_blocked_matmul_rows_keep_their_bits():
    g = torch.Generator().manual_seed(5)
    x = torch.randn((600, 32), generator=g)
    y = torch.randn((32, 40), generator=g)
    whole = blocked_matmul(x, y, SERVING_BLOCK_ROWS)
    for lo, hi in ((0, 1), (0, 2), (3, 7), (250, 262), (255, 600)):
        part = blocked_matmul(x[lo:hi], y, SERVING_BLOCK_ROWS)
        assert part.numpy().tobytes() == whole[lo:hi].numpy().tobytes()


def test_blocked_matmul_pads_only_a_partial_block(monkeypatch):
    cats = []
    real = torch.cat
    monkeypatch.setattr(torch, "cat",
                        lambda *a, **k: cats.append(1) or real(*a, **k))
    x, y = torch.ones((2 * SERVING_BLOCK_ROWS, 4)), torch.ones((4, 3))
    blocked_matmul(x, y, SERVING_BLOCK_ROWS)
    assert not cats
    blocked_matmul(x[:5], y, SERVING_BLOCK_ROWS)
    blocked_matmul(x[:SERVING_BLOCK_ROWS], y, SERVING_BLOCK_ROWS)
    assert len(cats) == 2     # each padded to two blocks


@pytest.mark.parametrize("model", sorted(MODELS))
def test_export_runs_the_blocked_product_at_any_batch(saved, model):
    d, n_mul = saved[model]
    ep = torch.export.load(BytesIO(tfluid.io.read_artifact_bytes(
        d + "/" + tfluid.io.AOT_FILE)))
    ops = [n for n in ep.graph.nodes
           if n.op == "call_function"
           and n.target == torch.ops.paddle_tpu_torch.blocked_mm.default]
    assert n_mul > 0 and len(ops) == n_mul
    for node in ops:
        assert isinstance(node.args[0].meta["val"].shape[0], torch.SymInt)
        assert node.args[2] == SERVING_BLOCK_ROWS
    assert not [n for n in ep.graph.nodes if n.op == "call_function"
                and n.target in (torch.ops.aten.mm.default,
                                 torch.ops.aten.bmm.default)]


@pytest.mark.parametrize("model,rows", [
    ("transformer", 2), ("transformer", 5), ("transformer", 8),
    ("transformer", ROWS_PER_BLOCK + 3),
    ("mlp", 1), ("mlp", 3), ("mlp", 16), ("mlp", SERVING_BLOCK_ROWS + 44)])
def test_aot_gives_the_program_backends_bits(saved, model, rows):
    d, _ = saved[model]
    feed = MODELS[model][1](rows, seed=rows)
    got = _aot_backend(d)(feed)
    want = _program_backend(d)(feed)
    assert got.shape[0] == rows
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("model,whole,step", [
    ("transformer", 8, 2), ("transformer", ROWS_PER_BLOCK + 4, 4),
    ("mlp", 16, 2), ("mlp", SERVING_BLOCK_ROWS + 44, 50)])
def test_alone_equals_coalesced_on_both_backends(saved, model, whole, step):
    d, _ = saved[model]
    make = MODELS[model][1]
    big = make(whole, seed=3)
    for run in (_aot_backend(d), _program_backend(d)):
        out = run(big)
        for i in range(0, whole, step):
            alone = run({k: v[i:i + step] for k, v in big.items()})
            assert alone.tobytes() == out[i:i + step].tobytes(), i


def test_f32_bf16_reduction_restores_the_callers_setting():
    matmul = torch.backends.cuda.matmul
    saved_flag = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        inside, go, done = [], threading.Event(), threading.Event()

        def other():
            with core.f32_bf16_reduction("cuda"):
                go.set()
                done.wait(10)
                inside.append(matmul.allow_bf16_reduced_precision_reduction)

        t = threading.Thread(target=other)
        with core.f32_bf16_reduction("cuda"):
            inside.append(matmul.allow_bf16_reduced_precision_reduction)
            t.start()
            go.wait(10)
        # the other run is still inside: the switch stays off for it
        inside.append(matmul.allow_bf16_reduced_precision_reduction)
        done.set()
        t.join(10)
        assert inside == [False, False, False]
        assert matmul.allow_bf16_reduced_precision_reduction is True
        with core.f32_bf16_reduction("cpu"):    # the CPU: left alone
            assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved_flag
