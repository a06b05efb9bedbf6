"""LayerHelper: shared plumbing for every layer function
(reference: python/paddle/fluid/layer_helper.py).

Creates parameters (registering their init op in the *startup* program),
temp variables, appends ops, and applies activations/bias.
"""
from __future__ import annotations

import copy

from . import unique_name
from .core import is_float_dtype
from .framework import (
    Parameter,
    Variable,
    default_main_program,
    default_startup_program,
    _name_scope,
)
from .initializer import Constant, Xavier
from .param_attr import ParamAttr, WeightNormParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            name = unique_name.generate(_name_scope.prefix() + layer_type)
        self.name = name

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # -- inputs --------------------------------------------------------------
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError("%s layer needs exactly 1 input" % self.layer_type)
        return inputs[0]

    def input_dtype(self, input_param_name="input"):
        dtype = None
        for v in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = v.dtype
            elif dtype != v.dtype:
                raise ValueError("mismatched input dtypes: %s vs %s" % (dtype, v.dtype))
        return dtype

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        pa = self.param_attr
        if isinstance(pa, ParamAttr):
            pa = [pa]
        if len(pa) == 1 and length != 1:
            pa = pa + [copy.deepcopy(pa[0]) for _ in range(length - 1)]
        return pa

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attrs = self.multiple_param_attr(len(inputs))
        return zip(inputs, attrs)

    # -- variable / parameter creation ---------------------------------------
    def create_parameter(self, attr, shape, dtype, is_bias=False, default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if default_initializer is None:
            if is_bias:
                attr._set_default_initializer(Constant(0.0))
            elif is_float_dtype(dtype):
                attr._set_default_initializer(Xavier())
            else:
                attr._set_default_initializer(Constant(0.0))
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "b" if is_bias else "w"]))

        shape = [int(s) for s in shape]
        main_block = self.main_program.global_block()
        if attr.name in main_block.vars and isinstance(main_block.vars[attr.name], Parameter):
            # shared parameter (explicit ParamAttr name reuse)
            return main_block.vars[attr.name]

        param = main_block.create_parameter(shape=shape, dtype=dtype, **attr._to_kwargs())
        # startup twin + its init op
        sb = self.startup_program.global_block()
        twin = sb.create_var(
            name=param.name, shape=shape, dtype=dtype, persistable=True
        )
        attr.initializer(twin, sb)
        return param

    def get_parameter(self, name):
        param = self.main_program.global_block().vars.get(name)
        if not isinstance(param, Parameter):
            raise ValueError("no parameter named %r" % (name,))
        return param

    def create_variable_for_type_inference(self, dtype, shape=None, stop_gradient=False, lod_level=None):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            shape=shape,
            persistable=False,
            stop_gradient=stop_gradient,
            lod_level=lod_level or 0,
        )

    # older reference spelling
    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, **kwargs):
        return self.block.create_var(**kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs
        )

    def set_variable_initializer(self, var, initializer):
        """Create a startup twin for ``var`` and register its initializer."""
        sb = self.startup_program.global_block()
        twin = sb.create_var(
            name=var.name, shape=var.shape, dtype=var.dtype, persistable=True
        )
        initializer(twin, sb)
        return var

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    # -- bias / activation ---------------------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype, shape=input_var.shape)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype, shape=input_var.shape)
        self.append_op(
            type=act_type, inputs={"X": [input_var]}, outputs={"Out": [tmp]}, attrs=act
        )
        return tmp
