"""Optimizers (reference: python/paddle/fluid/optimizer.py).

The port's copy of the JAX package's ``paddle_tpu/optimizer.py``:
``minimize`` appends backward + clip + regularization + per-parameter
update ops to the Program, with accumulators as persistable vars
initialized in the startup program.  Every optimizer builds its ops;
the port's executor has rules for the update ops it runs so far (adam).
"""
from __future__ import annotations

from collections import defaultdict

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import Program, Variable, default_main_program, default_startup_program, op_role_guard, OpRole, program_guard
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = [
    "SGD",
    "Momentum",
    "Adagrad",
    "Adam",
    "Adamax",
    "DecayedAdagrad",
    "Adadelta",
    "RMSProp",
    "Ftrl",
    "SGDOptimizer",
    "MomentumOptimizer",
    "AdagradOptimizer",
    "AdamOptimizer",
    "AdamaxOptimizer",
    "DecayedAdagradOptimizer",
    "AdadeltaOptimizer",
    "RMSPropOptimizer",
    "FtrlOptimizer",
    "Optimizer",
    "ModelAverage",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, LARS_weight_decay=0.0, name=None):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        # keyed by the Program OBJECT (weakly): id() is recycled by the GC,
        # so an id-keyed map can hand program B the LR variable of a dead
        # program A allocated at the same address
        import weakref

        self._learning_rate_map = weakref.WeakKeyDictionary()
        if isinstance(learning_rate, Variable):
            self._learning_rate_map[default_main_program()] = learning_rate
        self._accumulators = defaultdict(dict)
        self.helper = None
        self._LARS_weight_decay = LARS_weight_decay

    # -- learning rate -------------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        lr = self._global_learning_rate(program)
        if lr is not None:
            return
        if not isinstance(self._learning_rate, (float, int)):
            raise ValueError("learning rate variable was created in another program")
        from .layers import tensor

        self._learning_rate_map[program] = tensor.create_global_var(
            name=unique_name.generate("learning_rate"),
            shape=[1],
            value=float(self._learning_rate),
            dtype="float32",
            persistable=True,
        )

    def _global_learning_rate(self, program=None):
        program = program or default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = param.optimize_attr.get("learning_rate", 1.0) if param.optimize_attr else 1.0
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        from .layers import nn

        return nn.scale(base, scale=float(param_lr))

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0, shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(self.__class__.__name__)
        # Accumulators live in f32 regardless of param dtype: the update-op
        # lowerings do all math in f32 (master-weight recipe), and a
        # half-precision accumulator would both lose small updates and flip
        # the state dtype between steps (retriggering jit compilation).
        acc_dtype = dtype or param.dtype
        if str(acc_dtype) in ("bfloat16", "float16"):
            acc_dtype = "float32"
        var = helper.create_global_variable(
            name=unique_name.generate(param.name + "_" + name),
            persistable=True,
            dtype=acc_dtype,
            shape=shape if shape is not None else param.shape,
        )
        var.stop_gradient = True
        # the ZeRO sharding pass (executor; BuildStrategy.zero_stage)
        # partitions exactly the vars carrying this tag over 'dp'
        var.is_optimizer_state = True
        helper.set_variable_initializer(var, Constant(value=float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- virtuals ------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- minimize ------------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss, startup_program=None):
        program = loss.block.program
        with program_guard(program, startup_program or default_startup_program()):
            with op_role_guard(OpRole.Optimize):
                self._create_accumulators(
                    loss.block, [p for p, g in parameters_and_grads if g is not None]
                )
                self._create_global_learning_rate()
                optimize_ops = []
                for param_and_grad in parameters_and_grads:
                    if param_and_grad[1] is None:
                        continue
                    if param_and_grad[0].trainable:
                        optimize_ops.append(self._append_optimize_op(loss.block, param_and_grad))
                self._finish_update(loss.block, parameters_and_grads)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        with program_guard(loss.block.program, startup_program or default_startup_program()):
            params_grads = append_backward(loss, parameter_list, no_grad_set)
            params_grads = sorted(params_grads, key=lambda x: x[0].name)
            with op_role_guard(OpRole.Optimize):
                params_grads = append_gradient_clip_ops(params_grads)
                params_grads = append_regularization_ops(params_grads, self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads, loss, startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]]},
        )


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity_acc = self._get_accumulator(self._velocity_acc_str, param_and_grad[0])
        return block.append_op(
            type="momentum",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "Velocity": [velocity_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]], "VelocityOut": [velocity_acc]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1.0e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="adagrad",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "Moment": [moment_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment_acc]},
            attrs={"epsilon": self._epsilon},
        )


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, fill_value=self._beta1, shape=[1])
            self._add_accumulator(self._beta2_pow_acc_str, p, fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        return block.append_op(
            type="adam",
            inputs={
                "Param": [p],
                "Grad": [param_and_grad[1]],
                "Moment1": [self._get_accumulator(self._moment1_acc_str, p)],
                "Moment2": [self._get_accumulator(self._moment2_acc_str, p)],
                "Beta1Pow": [self._get_accumulator(self._beta1_pow_acc_str, p)],
                "Beta2Pow": [self._get_accumulator(self._beta2_pow_acc_str, p)],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [p],
                "Moment1Out": [self._get_accumulator(self._moment1_acc_str, p)],
                "Moment2Out": [self._get_accumulator(self._moment2_acc_str, p)],
                "Beta1PowOut": [self._get_accumulator(self._beta1_pow_acc_str, p)],
                "Beta2PowOut": [self._get_accumulator(self._beta2_pow_acc_str, p)],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        return block.append_op(
            type="adamax",
            inputs={
                "Param": [p],
                "Grad": [param_and_grad[1]],
                "Moment": [self._get_accumulator(self._moment_acc_str, p)],
                "InfNorm": [self._get_accumulator(self._inf_norm_acc_str, p)],
                "Beta1Pow": [self._get_accumulator(self._beta1_pow_acc_str, p)],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [p],
                "MomentOut": [self._get_accumulator(self._moment_acc_str, p)],
                "InfNormOut": [self._get_accumulator(self._inf_norm_acc_str, p)],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )

    def _finish_update(self, block, parameters_and_grads):
        """update beta1 pow accumulator (reference optimizer.py Adamax)."""
        for param, grad in parameters_and_grads:
            if grad is None:
                continue
            acc = self._get_accumulator(self._beta1_pow_acc_str, param)
            block.append_op(
                type="scale",
                inputs={"X": [acc]},
                outputs={"Out": [acc]},
                attrs={"scale": self._beta1},
            )


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1.0e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="decayed_adagrad",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "Moment": [moment_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment_acc]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1.0e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        g_acc = self._get_accumulator(self._avg_squared_grad_acc_str, param_and_grad[0])
        u_acc = self._get_accumulator(self._avg_squared_update_acc_str, param_and_grad[0])
        return block.append_op(
            type="adadelta",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "AvgSquaredGrad": [g_acc],
                "AvgSquaredUpdate": [u_acc],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "AvgSquaredGradOut": [g_acc],
                "AvgSquaredUpdateOut": [u_acc],
            },
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(self, learning_rate, rho=0.95, epsilon=1.0e-6, momentum=0.0, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            if self._centered:
                self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        inputs = {
            "Param": [p],
            "Grad": [param_and_grad[1]],
            "Moment": [self._get_accumulator(self._momentum_acc_str, p)],
            "MeanSquare": [self._get_accumulator(self._mean_square_acc_str, p)],
            "LearningRate": [self._create_param_lr(param_and_grad)],
        }
        outputs = {
            "ParamOut": [p],
            "MomentOut": [self._get_accumulator(self._momentum_acc_str, p)],
            "MeanSquareOut": [self._get_accumulator(self._mean_square_acc_str, p)],
        }
        if self._centered:
            inputs["MeanGrad"] = [self._get_accumulator(self._mean_grad_acc_str, p)]
            outputs["MeanGradOut"] = [self._get_accumulator(self._mean_grad_acc_str, p)]
        return block.append_op(
            type="rmsprop",
            inputs=inputs,
            outputs=outputs,
            attrs={
                "epsilon": self._epsilon,
                "decay": self._rho,
                "momentum": self._momentum,
                "centered": self._centered,
            },
        )


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        return block.append_op(
            type="ftrl",
            inputs={
                "Param": [p],
                "Grad": [param_and_grad[1]],
                "SquaredAccumulator": [self._get_accumulator(self._squared_acc_str, p)],
                "LinearAccumulator": [self._get_accumulator(self._linear_acc_str, p)],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [p],
                "SquaredAccumOut": [self._get_accumulator(self._squared_acc_str, p)],
                "LinearAccumOut": [self._get_accumulator(self._linear_acc_str, p)],
            },
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class ModelAverage(Optimizer):
    """Running average of parameters applied at eval time
    (reference optimizer.py:1189).  ``apply()`` swaps params for their
    accumulated average; ``restore()`` swaps back."""

    def __init__(self, average_window_rate, min_average_window=10000, max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        self._registered = False
        # reference semantics: constructing ModelAverage inside the program
        # context (after the real optimizer's minimize) registers the
        # accumulator ops immediately.  Deferred explicitly when there is
        # nothing to register yet — a bare except here would also mask real
        # registration failures as "not registered"
        if any(p.trainable for p in default_main_program().global_block().all_parameters()):
            self._register()

    def _register(self, program=None):
        program = program or default_main_program()
        params = [p for p in program.global_block().all_parameters() if p.trainable and getattr(p, "do_model_average", None) is not False]
        with program_guard(program, default_startup_program()):
            with op_role_guard(OpRole.Optimize):
                for param in params:
                    self._add_accumulator("sum", param)
                    cnt = self._add_accumulator("num_accumulates", param, dtype="int64", shape=[1])
                    s = self._get_accumulator("sum", param)
                    param.block.program.global_block().append_op(
                        type="average_accumulate",
                        inputs={"Param": [param], "Sum": [s], "Num": [cnt]},
                        outputs={"SumOut": [s], "NumOut": [cnt]},
                        attrs={},
                    )
        self._params = params
        self._registered = True

    def apply(self, executor, need_restore=True):
        import contextlib

        from .executor import global_scope
        import numpy as np

        if not self._registered:
            raise RuntimeError("ModelAverage must be registered before apply (call minimize or _register)")
        scope = global_scope()
        self._backup = {}

        @contextlib.contextmanager
        def _ctx():
            for p in self._params:
                self._backup[p.name] = np.asarray(scope[p.name])
                s = np.asarray(scope[self._get_accumulator("sum", p).name])
                n = max(int(np.asarray(scope[self._get_accumulator("num_accumulates", p).name])[0]), 1)
                # the f32 running sum must not change the param's stored dtype
                scope[p.name] = (s / n).astype(self._backup[p.name].dtype)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)

        return _ctx()

    def restore(self, executor):
        from .executor import global_scope

        scope = global_scope()
        for name, val in self._backup.items():
            scope[name] = val

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        raise TypeError("ModelAverage wraps a trained program; call _register() after the real optimizer's minimize")


# short aliases (as exported by the reference fluid.optimizer)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
