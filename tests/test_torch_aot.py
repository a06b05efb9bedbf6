"""The port's AOT backend: ``io.save_inference_model(..., aot=True)``
writes a ``torch.export`` graph (``__aot_torch__``) with a symbolic batch
dimension, and ``io.load_aot_inference_model`` runs it with no Program
rebuild.  On the CPU, at small sizes:

* the artifact predicts bitwise what the Program backend predicts (the
  exported graph runs the same torch ops in the same order), at batches
  1, 3 and 16 from one artifact;
* the flash Transformer (2+2 layers, d_model 64, 16 tokens) exports
  through the flash forward operator, ``paddle_tpu_torch::flash_fwd``,
  which is B1 as a ``torch.library.custom_op``: its CPU implementation
  is the plain version (bitwise), its fake implementation gives the
  shapes, and its CUDA implementation is the kernel wrapper;
* a fresh process with jax blocked loads the artifact and predicts;
* a directory with only the JAX package's ``__aot__`` is refused with
  ``ServingError`` naming it, and so is an artifact loaded on a device
  other than the one it was exported on.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.parallel import flash_attention as tfa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSFORMER = dict(batch_size=2, seq_len=16, src_vocab_size=500,
                   trg_vocab_size=500, max_length=16, n_layer=2, n_head=2,
                   d_model=64, d_inner=128, dropout=0.1, use_flash=True)


def _save_mlp(fluid, dirname, seed=17, aot=True):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        out = fluid.layers.fc(h, size=4, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                      main_program=main, aot=aot)
    return dirname


def _transformer_feed(rows, seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, 500, size=(rows, 16)).astype("int64")
    trg = rng.randint(3, 500, size=(rows, 16)).astype("int64")
    src[0, 9:] = 0      # pad tails: the flash forward's kv_lens
    trg[-1, 4:] = 0
    if rows > 2:
        src[1] = 0      # an all-pad row: kv_lens 0
        trg[1] = 0
    return {"src_word": src, "trg_word": trg}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("aot")
    out = {"mlp": _save_mlp(tfluid, str(root / "mlp"))}
    with tfluid.unique_name.guard():
        m = TT.get_model(**TRANSFORMER)
    m["startup"].random_seed = 5
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(m["startup"])
        tfluid.io.save_inference_model(
            str(root / "transformer"), ["src_word", "trg_word"],
            [m["predict"]], exe, main_program=m["test"], aot=True)
    out["transformer"] = str(root / "transformer")
    return out


def _program_predict(dirname, feed):
    """The serving Program backend's answer: each ``mul`` in blocks of
    ``SERVING_BLOCK_ROWS`` rows, as the exported graph multiplies."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.block_rows = tfluid.executor.SERVING_BLOCK_ROWS
    with tfluid.scope_guard(tfluid.Scope()):
        prog, _, fetch = tfluid.io.load_inference_model(dirname, exe)
        return exe.run(prog, feed=feed, fetch_list=fetch)


def _feed(name, rows, seed):
    if name == "mlp":
        return {"x": np.random.RandomState(seed).randn(rows, 8)
                .astype("float32")}
    return _transformer_feed(rows, seed)


@pytest.mark.parametrize("rows", [1, 3, 16])
@pytest.mark.parametrize("name", ["mlp", "transformer"])
def test_aot_equals_the_program_backend_bitwise(dirs, name, rows):
    """One artifact, a symbolic batch: every batch size runs, and gives
    the Program backend's bits."""
    d = dirs[name]
    assert os.path.exists(os.path.join(d, tfluid.io.AOT_FILE))
    predict, feed_names, fetch_names = tfluid.io.load_aot_inference_model(
        d, device="cpu")
    feed = _feed(name, rows, seed=rows)
    assert sorted(feed_names) == sorted(feed)
    (got,) = predict(feed)
    (want,) = _program_predict(d, feed)
    assert got.shape[0] == rows and np.isfinite(got).all()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_meta_records_the_feed_specs_and_the_device(dirs):
    with open(os.path.join(dirs["transformer"],
                           tfluid.io.AOT_META_FILE)) as f:
        meta = json.load(f)
    assert meta["feed_names"] == ["src_word", "trg_word"]
    assert meta["feed_shapes"] == [["b", "16"], ["b", "16"]]
    assert meta["feed_dtypes"] == ["int64", "int64"]
    assert meta["device"] == "cpu"
    assert len(meta["fetch_names"]) == 1


def test_flash_transformer_exports_through_the_custom_op(dirs):
    """Every attention of the pruned Transformer (2 encoder, 2 decoder
    self, 2 cross) is one call of the flash forward operator in the
    exported graph."""
    ep = torch.export.load(os.path.join(dirs["transformer"],
                                        tfluid.io.AOT_FILE))
    calls = [n for n in ep.graph.nodes if n.op == "call_function"
             and "paddle_tpu_torch.flash_fwd" in str(n.target)]
    assert len(calls) == 3 * TRANSFORMER["n_layer"]


def test_custom_op_is_b1_on_each_device():
    """CPU: the plain version's bits; fake: the out and lse shapes and
    dtypes; CUDA: a kernel is registered (the wrapper; no card here)."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, 24, 32).astype("float32"))
               for _ in range(3))
    lens = torch.tensor([24, 0], dtype=torch.int32)
    for causal in (False, True):
        out, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, lens,
                                                        causal, 0.3)
        ref_out, ref_lse = tfa._flash_fwd_reference(q, k, v, lens, causal,
                                                    0.3)
        assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        for dtype, lse_dtype in ((torch.float32, torch.float32),
                                 (torch.bfloat16, torch.float32),
                                 (torch.float64, torch.float64)):
            fq = torch.empty((2, 3, 5, 32), dtype=dtype)
            fk = torch.empty((2, 3, 7, 32), dtype=dtype)
            out, lse = torch.ops.paddle_tpu_torch.flash_fwd(
                fq, fk, fk, None, False, 0.3)
            assert out.shape == (2, 3, 5, 32) and out.dtype == dtype
            assert lse.shape == (2, 3, 5) and lse.dtype == lse_dtype
    assert torch._C._dispatch_has_kernel_for_dispatch_key(
        "paddle_tpu_torch::flash_fwd", "CUDA")
    assert torch._C._dispatch_has_kernel_for_dispatch_key(
        "paddle_tpu_torch::flash_fwd", "CPU")


def test_cpu_op_calls_count_no_launch():
    before = dict(tfa.KERNEL_LAUNCHES)
    q = torch.zeros((1, 1, 4, 32))
    torch.ops.paddle_tpu_torch.flash_fwd(q, q, q, None, False, 1.0)
    tfa.flash_attention(q, q, q)
    assert tfa.KERNEL_LAUNCHES == before


def test_launch_counts_survive_concurrent_increments():
    """The predict batcher and the decode worker count launches from two
    threads; no increment may be lost (a shortened switch interval makes
    a lost read-modify-write likely if the count were not locked)."""
    saved = dict(tfa.KERNEL_LAUNCHES)
    saved_by_dtype = {k: dict(v) for k, v in
                      tfa.KERNEL_LAUNCHES_BY_DTYPE.items()}
    interval = sys.getswitchinterval()
    n_threads, per = 8, 2000
    try:
        tfa.reset_launch_counts()
        sys.setswitchinterval(1e-6)

        def work():
            for _ in range(per):
                tfa._count_launch("flash_attention_fwd",
                                  "paged_decode_attention",
                                  dtype=torch.bfloat16)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert tfa.KERNEL_LAUNCHES["flash_attention_fwd"] == n_threads * per
        assert tfa.KERNEL_LAUNCHES["paged_decode_attention"] == \
            n_threads * per
        assert tfa.KERNEL_LAUNCHES_BY_DTYPE["flash_attention_fwd"] == {
            "float32": 0, "bfloat16": n_threads * per}
    finally:
        sys.setswitchinterval(interval)
        tfa.KERNEL_LAUNCHES.update(saved)
        for k, v in saved_by_dtype.items():
            tfa.KERNEL_LAUNCHES_BY_DTYPE[k].update(v)


_CHILD = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np
import paddle_tpu_torch as fluid
d, feed_file, out_file = sys.argv[1:4]
predict, feeds, fetches = fluid.io.load_aot_inference_model(d, device="cpu")
data = np.load(feed_file)
(out,) = predict({n: data[n] for n in feeds})
np.save(out_file, out)
assert not any(m == "paddle_tpu" or m.startswith("paddle_tpu.")
               for m in sys.modules)
print("OK", out.shape)
"""


def test_fresh_process_without_jax_loads_and_predicts(dirs, tmp_path):
    feed = _transformer_feed(3, seed=9)
    np.savez(str(tmp_path / "feed.npz"), **feed)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, dirs["transformer"],
         str(tmp_path / "feed.npz"), str(tmp_path / "out.npy")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = np.load(str(tmp_path / "out.npy"))
    (want,) = _program_predict(dirs["transformer"], feed)
    assert got.tobytes() == want.tobytes()


def test_jax_only_aot_directory_is_refused(tmp_path):
    """The JAX package's ``__aot__`` is a jax.export artifact: the port
    neither loads it nor mistakes it for its own."""
    d = str(tmp_path / "jax_model")
    with jfluid.scope_guard(jfluid.Scope()):
        _save_mlp(jfluid, d, aot=True)
    assert os.path.exists(os.path.join(d, "__aot__"))
    store = serving.ModelStore(place=tfluid.CPUPlace())
    with pytest.raises(serving.ServingError, match="__aot__"):
        store.load(d, backend="aot")
    # auto falls to the Program, which the port reads
    model = store.load(d, backend="auto")
    assert model.kind == "program"
    assert model.predict_batch({"x": np.zeros((2, 8), "float32")})[0].shape \
        == (2, 4)


def test_artifact_on_another_device_is_refused(dirs, tmp_path):
    d = str(tmp_path / "moved")
    _save_mlp(tfluid, d)
    meta_path = os.path.join(d, tfluid.io.AOT_META_FILE)
    with open(meta_path) as f:
        meta = json.load(f)
    meta["device"] = "cuda:0"      # as if exported on the card
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(serving.ServingError, match="cuda:0"):
        tfluid.io.load_aot_inference_model(d, device="cpu")
    with pytest.raises(serving.ServingError, match="exported on"):
        serving.ModelStore(place="cpu").load(d, backend="aot")


def test_aot_needs_static_non_batch_dims(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[-1, 8], dtype="float32",
                               append_batch_size=False)
        seq = tfluid.layers.data(name="s", shape=[-1, -1], dtype="float32",
                                 append_batch_size=False)
        out = tfluid.layers.elementwise_add(
            tfluid.layers.fc(x, size=4), tfluid.layers.reduce_sum(
                seq, dim=1, keep_dim=True))
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        with pytest.raises(ValueError, match="aot_feed_shapes"):
            tfluid.io.save_inference_model(
                str(tmp_path / "m"), ["x", "s"], [out], exe,
                main_program=main, aot=True)
        # with the full shape given, it exports and serves
        tfluid.io.save_inference_model(
            str(tmp_path / "m"), ["x", "s"], [out], exe, main_program=main,
            aot=True, aot_feed_shapes={"s": [-1, 5]})
    predict, _, _ = tfluid.io.load_aot_inference_model(str(tmp_path / "m"),
                                                       device="cpu")
    (got,) = predict({"x": np.ones((3, 8), "float32"),
                      "s": np.ones((3, 5), "float32")})
    assert got.shape == (3, 4)
