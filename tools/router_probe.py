#!/usr/bin/env python3
"""chip_smoke.py's router phase alone on one CUDA card.

    python3 tools/router_probe.py

It builds the kernels, serves the serving phase's 16 prompts on an
engine for their tokens (the tokens lm-a must give through the router),
saves the predict phase's two scoring versions into a temporary
directory, runs ``router_phase`` and prints its result as the last line.
The serving LM at chip_smoke's width, random weights from its seed.
"""
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as c  # noqa: E402


def main():
    import torch

    if not torch.cuda.is_available():
        print("router_probe: needs a CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import cuda_kernels, observability as obs, serving
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import flash_attention as fa

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card:", c.card_line(), flush=True)
    cuda_kernels.load_library()
    dev = torch.device("cuda", 0)
    params, meta = T.lm_params(seed=c.SEED, **c.LM_WIDTH)
    model = T.build_decode_model(params, meta, device=dev)
    rng = np.random.RandomState(c.SEED + 3)     # the serving phase's
    prompts = [rng.randint(0, meta["vocab_size"], size=int(n))
               .astype(np.int32)
               for n in rng.randint(32, 1501, size=c.N_REQUESTS)]
    engine = serving.InferenceEngine(
        decode_model=model,
        decode_config=serving.DecodeConfig(**c.DECODE_CONFIG), device=dev)
    want = [f.result(timeout=600) for f in [
        engine.generate_async(p, max_new_tokens=c.NEW_TOKENS)
        for p in prompts]]
    engine.stop()
    del engine, model
    root = tempfile.mkdtemp(prefix="router_models_")
    try:
        saved = c.save_predict_models(torch, fluid, T, root)
        out = c.router_phase(torch, T, serving, fa, obs, dev, prompts, want,
                             saved)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["command_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
