"""A Program as a plain function of its state and feeds.

The port's counterpart of the JAX package's ``paddle_tpu/jax_bridge.py``
(``program_to_fn``, ``init_state``): given a Program and fetch targets,
``program_to_fn`` returns ``fn(state, feeds, seed=0) -> [fetches]`` over
dicts of tensors, run by the same op rules as ``Executor.run`` but with
no scope; ``init_state`` runs a startup Program into a fresh state dict.
The JAX package's ``aot_compile`` (an ahead-of-time ``jax.jit``
lowering for fixed shapes) is not ported; the port's ahead-of-time path
is ``io.save_inference_model(..., aot=True)``, a ``torch.export`` graph.
"""
from __future__ import annotations

from .core import f32_bf16_reduction, resolve_device
from .executor import LoweringContext, _as_tensor, lower_block
from .framework import Program, Variable

__all__ = ["program_to_fn", "init_state"]


def program_to_fn(program: Program, fetch_list, is_test=False,
                  return_state=False, device=None):
    """``fn(state, feeds, seed=0)``: run ``program`` once on ``device``
    (None: the card, raising without one) from ``state`` and ``feeds``
    (``{name: tensor or ndarray}``, each in its own dtype: a bfloat16
    state runs the Program in bfloat16, as the JAX package's does) and
    return the fetches as tensors — and, with ``return_state``, the
    persistables it left, as a dict."""
    dev = resolve_device(device)
    fetch_names = [f.name if isinstance(f, Variable) else str(f) for f in fetch_list]
    persistable = program.persistable_names()

    def fn(state, feeds, seed=0):
        env = {n: _as_tensor(v, None, dev) for n, v in state.items()}
        env.update({n: _as_tensor(v, None, dev) for n, v in feeds.items()})
        ctx = LoweringContext(program, env, dev, seed=seed, is_test=is_test)
        with f32_bf16_reduction(dev):
            lower_block(ctx, program.global_block())
        fetches = [ctx.env[n].detach() for n in fetch_names]
        if return_state:
            new_state = {n: v.detach() for n, v in ctx.env.items()
                         if n in persistable}
            return fetches, new_state
        return fetches

    return fn


def init_state(startup_program: Program, seed=0, device=None):
    """Run the startup Program on ``device`` (None: the card) and return
    the initialized persistable state as ``{name: tensor}``."""
    dev = resolve_device(device)
    env = {}
    ctx = LoweringContext(startup_program, env, dev, seed=seed)
    lower_block(ctx, startup_program.global_block())
    persistable = startup_program.persistable_names()
    return {n: v for n, v in ctx.env.items() if n in persistable}
