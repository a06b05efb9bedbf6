"""ParallelExecutor: the Fluid data-parallel surface over a device mesh.

The port's counterpart of the JAX package's ``parallel_executor.py``
(reference: python/paddle/fluid/parallel_executor.py).  A mesh is a
record of devices laid out on named axes (``build_mesh``), and every
entry point that takes one — ``ParallelExecutor``, ``Trainer(parallel=)``,
``Inferencer(parallel=)`` — goes through ``Executor.attach_mesh``.

A mesh is a list of ranks (``parallel.collective.Mesh``), and the list
may name one device more than once: ``devices=["cuda:0"] * 4`` runs four
ranks on one card, ``devices=["cpu"] * 8`` eight on the CPU, as the JAX
package's tests run eight virtual CPU devices.  ``devices=None`` is every
card.  A mesh of one rank runs the Program exactly as ``Executor.run``
does, the bound step and its CUDA graph included.  On more ranks the step
is the executor's mesh step (``mesh_step``): the batch split over ``dp``,
parameters laid out over ``tp`` (``sharding_rules``), ZeRO
(``zero_stage``), and the ``sp``, ``ep`` and ``pp`` engines of the
attention, ``switch_moe`` and ``pipeline`` rules; fetches come back as
global values.  A mesh that needs more ranks than are given raises the
JAX package's ``ValueError``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import observability as _obs
from .core import resolve_device
from .executor import Executor, global_scope
from .framework import default_main_program, Variable
from .parallel.collective import Mesh

__all__ = ["ParallelExecutor", "ExecutionStrategy", "BuildStrategy", "build_mesh",
           "Mesh"]


class ExecutionStrategy:
    """Kept for API parity; the knobs have nothing to steer in the port's
    executor, which runs a step as one CUDA graph."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


class BuildStrategy:
    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        self.enable_data_balance = False
        # the JAX package's extensions (no reference analog — the
        # reference is dp-only): mesh_shape, a (dp, tp[, sp]) tuple or an
        # {axis: size} dict; sharding_rules, [(param_name_regex, spec)]
        # overrides of the tensor-parallel split; zero_stage, 0 (off),
        # 1 (optimizer accumulators dp-sharded) or 3 (parameters too)
        self.mesh_shape = None
        self.sharding_rules = None
        self.zero_stage = 0


def _card_devices():
    """Every card's device; raises without a card (``resolve_device``)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(mesh_shape=None, devices=None):
    """(dp, tp[, sp]) tuple / {axis: size} dict (any axis names: ``dp``,
    ``tp``, ``sp``, ``ep``, ``pp``) / None -> :class:`Mesh`.  None or True
    means a 1-D data-parallel mesh over all ranks; ``devices`` lists the
    ranks' devices, repeats allowed, and None means every card's
    device."""
    devs = [resolve_device(d) for d in (devices if devices is not None
                                        else _card_devices())]
    if not mesh_shape or mesh_shape is True:
        names, sizes = ("dp",), (len(devs),)
    elif isinstance(mesh_shape, dict):
        names = tuple(mesh_shape)
        sizes = tuple(int(mesh_shape[n]) for n in names)
    else:
        sizes = tuple(int(s) for s in mesh_shape)
        names = ("dp", "tp", "sp")[: len(sizes)]
    need = int(np.prod(sizes))
    if need > len(devs):
        raise ValueError(
            "mesh_shape %r needs %d devices, only %d available"
            % (mesh_shape, need, len(devs)))
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(devs[:need]):
        grid[i] = d
    return Mesh(grid.reshape(sizes), names)


class ParallelExecutor:
    """``ParallelExecutor(loss_name=..., main_program=...)``: runs the
    Program over a mesh (``mesh_shape``, else ``build_strategy.mesh_shape``,
    else every rank of ``devices``; ``devices=None`` is every card, and a
    device may be named more than once).
    ``use_cuda``, ``use_tpu``, ``exec_strategy``, ``num_trainers`` and
    ``trainer_id`` are taken for the reference's signature and steer
    nothing, as in the JAX package."""

    def __init__(
        self,
        use_cuda=None,
        loss_name=None,
        main_program=None,
        share_vars_from=None,
        exec_strategy=None,
        build_strategy=None,
        num_trainers=1,
        trainer_id=0,
        scope=None,
        use_tpu=True,
        devices=None,
        mesh_shape=None,
        sharding_rules=None,
        zero_stage=None,
    ):
        self._program = main_program or default_main_program()
        self._loss_name = loss_name
        self._scope = scope or global_scope()
        devs = [resolve_device(d) for d in (devices if devices is not None
                                            else _card_devices())]
        if mesh_shape is None and build_strategy is not None:
            mesh_shape = getattr(build_strategy, "mesh_shape", None)
        if sharding_rules is None and build_strategy is not None:
            sharding_rules = getattr(build_strategy, "sharding_rules", None)
        if zero_stage is None and build_strategy is not None:
            zero_stage = getattr(build_strategy, "zero_stage", 0)
        self._exe = Executor(device=devs[0])
        self._mesh = self._exe.attach_mesh(
            mesh_shape, sharding_rules=sharding_rules,
            zero_stage=zero_stage, devices=devs)
        if share_vars_from is not None:
            self._scope = share_vars_from._scope

    def _data_names(self):
        """Declared data vars of the bound program, cached per program
        version — the feed-list path runs per step and must not pay a
        list_vars() walk each call."""
        cached = getattr(self, "_data_names_cache", None)
        version = getattr(self._program, "version", 0)
        if cached is None or cached[0] != version:
            names = {v.name for v in self._program.list_vars()
                     if getattr(v, "is_data", False)}
            self._data_names_cache = cached = (version, names)
        return cached[1]

    @property
    def device_count(self):
        return self._mesh.size

    @property
    def fast_path(self):
        """Bound-program dispatch (``Executor.run``'s program cache):
        steady-state runs replay the bound step.  False runs every step op
        by op."""
        return self._exe.fast_path

    @fast_path.setter
    def fast_path(self, enabled):
        self._exe.fast_path = bool(enabled)

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True,
            use_program_cache=True):
        feed = feed if feed is not None else feed_dict
        if isinstance(feed, list):
            # the reference's per-device feed lists: each data var's
            # entries land on their ranks' devices, one global batch
            # (reader.device_prefetch.shard_feed_list)
            from .reader.device_prefetch import shard_feed_list

            with _obs.span("pe.shard_feed_list", n=len(feed)):
                feed = shard_feed_list(feed, self._mesh, self._data_names(),
                                       program=self._program)
        fetch_list = [f.name if isinstance(f, Variable) else f for f in (fetch_list or [])]
        return self._exe.run(
            self._program,
            feed=feed,
            fetch_list=fetch_list,
            scope=self._scope,
            return_numpy=return_numpy,
            use_program_cache=use_program_cache,
        )
