"""StateCell / TrainingDecoder / BeamSearchDecoder — the contrib decoder
API (reference: python/paddle/fluid/contrib/decoder/beam_search_decoder.py).

The port's copy of the JAX package's ``contrib/decoder`` module, over the
port's layers.  It composes layers only and holds no op of its own:

* ``TrainingDecoder`` is a ``layers.DynamicRNN`` whose memories are the
  StateCell's states (teacher forcing: one step a target token).
* ``BeamSearchDecoder`` keeps its decode state in **loop-carried
  variables** of a ``layers.While`` loop (write =
  ``layers.assign(..., output=var)``); the beam set stays a fixed
  ``[batch, beam]`` block, and finished beams are masked by
  ``layers.beam_search``'s end_id handling.  Each loop seed is emitted in
  the While's parent block (``_in_parent_block``), so the While carries
  it across iterations.  The port's ``while`` rule reads its condition on
  the host before each iteration, so a decode runs op by op (it is never
  captured as a CUDA graph).
* Beam lineage is an explicit ``parent_idx`` tensor (see
  ``layers.beam_search``), and hidden states follow their beam by a flat
  ``gather`` instead of the reference's ``sequence_expand`` on LoD.
"""
from __future__ import annotations

import contextlib

from paddle_tpu_torch import layers
from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState:
    """Initial hidden state for a StateCell: either an explicit variable or
    a constant tensor shaped like ``init_boot`` (reference
    beam_search_decoder.py:43)."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "InitState needs either init= or init_boot= to know its shape")
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape or init_boot.shape, dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _MemoryState:
    """TrainingDecoder binding: the state is a DynamicRNN memory."""

    def __init__(self, state_name, rnn_obj, init_state):
        self._state_name = state_name
        self._rnn_obj = rnn_obj
        self._state_mem = rnn_obj.memory(
            init=init_state.value, need_reorder=init_state.need_reorder)

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        self._rnn_obj.update_memory(self._state_mem, state)


class _SlotState:
    """BeamSearchDecoder binding: the state is a loop-carried variable of
    the While block, beam-expanded once up front to ``[batch*beam, ...]``
    rows so each beam owns a row (the static-shape analog of the
    reference's _ArrayState + sequence_expand).

    The seed expansion + assign MUST be emitted in the While's parent
    block: a var created inside the sub-block is block-local and would
    reset to its seed on every loop iteration (While._complete only
    carries outer-block vars written inside the body)."""

    def __init__(self, state_name, decoder, init_state):
        beam_size = decoder._beam_size
        with decoder._in_parent_block():
            init = init_state.value
            if beam_size > 1:
                tiled = layers.expand(
                    layers.unsqueeze(init, axes=[1]),
                    expand_times=[1, beam_size] + [1] * (len(init.shape) - 1),
                )
                init = layers.reshape(tiled, shape=[-1] + list(init.shape[1:]))
            self._slot = layers.assign(init)

    def get_state(self):
        return self._slot

    def update_state(self, state):
        layers.assign(state, output=self._slot)


class StateCell:
    """Named hidden states + named step inputs of an RNN cell, with a
    user-supplied updater; binds to a TrainingDecoder (scan memory) or a
    BeamSearchDecoder (loop-carried slot) on first use (reference
    beam_search_decoder.py:159)."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper("state_cell", name=name)
        self._cur_states = {}
        self._state_names = []
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError("every state must be an InitState, got %r"
                                 % type(state))
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = dict(inputs)
        self._out_state = out_state
        if out_state not in self._cur_states:
            raise ValueError("out_state %r is not one of the states" % out_state)
        self._state_updater = None
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._switched_decoder = False
        self._states_holder = {}

    # -- decoder handshake ---------------------------------------------------
    def _enter_decoder(self, decoder_obj):
        if self._in_decoder:
            raise ValueError("StateCell is already inside a decoder")
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder or self._cur_decoder_obj is not decoder_obj:
            raise ValueError("mismatched decoder leave")
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._switched_decoder = False

    def _switch_decoder(self):
        if not self._in_decoder:
            raise ValueError("StateCell must be inside a decoder")
        if self._switched_decoder:
            raise ValueError("state bindings already created")
        decoder = self._cur_decoder_obj
        for state_name in self._state_names:
            holder = self._states_holder.setdefault(state_name, {})
            if id(decoder) not in holder:
                init_state = self._cur_states[state_name]
                if not isinstance(init_state, InitState):
                    raise ValueError("state %r was already consumed" % state_name)
                if decoder.type == _DecoderType.TRAINING:
                    holder[id(decoder)] = _MemoryState(
                        state_name, decoder.dynamic_rnn, init_state)
                elif decoder.type == _DecoderType.BEAM_SEARCH:
                    holder[id(decoder)] = _SlotState(
                        state_name, decoder, init_state)
                else:
                    raise ValueError("unknown decoder type %r" % decoder.type)
            self._cur_states[state_name] = holder[id(decoder)].get_state()
        self._switched_decoder = True

    # -- user surface --------------------------------------------------------
    def get_state(self, state_name):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError("unknown state %r" % state_name)
        return self._cur_states[state_name]

    def get_input(self, input_name):
        if input_name not in self._inputs or self._inputs[input_name] is None:
            raise ValueError("input %r has not been provided" % input_name)
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        """Decorator registering the per-step state transition."""
        self._state_updater = updater
        return updater

    def compute_state(self, inputs):
        """Bind this step's inputs and run the updater."""
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for input_name, input_value in inputs.items():
            if input_name not in self._inputs:
                raise ValueError("unknown step input %r" % input_name)
            self._inputs[input_name] = input_value
        if self._state_updater is None:
            raise ValueError("no state_updater registered")
        self._state_updater(self)

    def update_states(self):
        """Commit the current state values into their decoder bindings."""
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for state_name, holder in self._states_holder.items():
            binding = holder.get(id(self._cur_decoder_obj))
            if binding is None:
                raise ValueError("state %r has no binding for this decoder"
                                 % state_name)
            binding.update_state(self._cur_states[state_name])

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder:
    """Teacher-forced decoder: the StateCell's transition inside a scan RNN
    (reference beam_search_decoder.py:384)."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._helper = LayerHelper("training_decoder", name=name)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = layers.DynamicRNN()
        self._type = _DecoderType.TRAINING
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)

    @contextlib.contextmanager
    def block(self):
        if self._status != TrainingDecoder.BEFORE_DECODER:
            raise ValueError("block() can only be entered once")
        self._status = TrainingDecoder.IN_DECODER
        with self._dynamic_rnn.block():
            yield
        self._status = TrainingDecoder.AFTER_DECODER
        self._state_cell._leave_decoder(self)

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return self._type

    def step_input(self, x):
        self._assert_in_decoder_block("step_input")
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_decoder_block("static_input")
        return self._dynamic_rnn.static_input(x)

    def output(self, *outputs):
        self._assert_in_decoder_block("output")
        self._dynamic_rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError("outputs are only available after the block")
        return self._dynamic_rnn(*args, **kwargs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError("%s() must be called inside decoder.block()" % method)


class BeamSearchDecoder:
    """Inference decoder: a While loop over a fixed ``[batch, beam]``
    block (reference beam_search_decoder.py:523).

    ``init_ids``/``init_scores`` are dense ``[batch, beam]`` tensors (seed
    scores with ``[0, -1e9, ...]`` per row — see ``layers.beam_search``);
    states passed via the StateCell are ``[batch, ...]`` and get
    beam-expanded to rows internally.  ``decode()`` wires the default
    embed -> transition -> project -> topk -> beam_search step; a custom
    step can be built inside ``block()`` with ``read_array``/
    ``update_array`` + ``early_stop``.
    """

    BEFORE_BEAM_SEARCH_DECODER = 0
    IN_BEAM_SEARCH_DECODER = 1
    AFTER_BEAM_SEARCH_DECODER = 2

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50, sparse_emb=True,
                 max_len=100, beam_size=1, end_id=1, name=None):
        self._helper = LayerHelper("beam_search_decoder", name=name)
        self._type = _DecoderType.BEAM_SEARCH
        self._status = BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER
        self._beam_size = beam_size
        self._end_id = end_id
        self._max_len = max_len
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._topk_size = min(topk_size, target_dict_dim)
        self._sparse_emb = sparse_emb
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})

        self._program = self._helper.main_program
        self._parent_block_idx = self._program.current_block_idx
        self._counter = layers.zeros(shape=[1], dtype="int64", force_cpu=True)
        self._counter.stop_gradient = True
        self._max_len_const = layers.fill_constant(
            shape=[1], dtype="int64", value=max_len)
        self._cond = layers.less_than(x=self._counter, y=self._max_len_const)
        self._while_op = layers.While(cond=self._cond, maxlen=max_len)

        self._ids_array = layers.create_array("int64", capacity=max_len)
        self._scores_array = layers.create_array("float32", capacity=max_len)
        self._parents_array = layers.create_array("int32", capacity=max_len)

        self._slots = {}          # read_array slots: name -> carried var
        self._tagged_arrays = {}  # is_ids/is_scores slots -> backtrace array
        self._pending = []        # update_array writes applied at step end

        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)

    @contextlib.contextmanager
    def _in_parent_block(self):
        """Emit ops into the While's parent block (loop seeds must live
        there to be loop-carried, not block-local)."""
        saved = self._program.current_block_idx
        self._program.current_block_idx = self._parent_block_idx
        try:
            yield
        finally:
            self._program.current_block_idx = saved

    @contextlib.contextmanager
    def block(self):
        """Open the decode loop.  At exit the pending update_array writes
        commit, the counter advances and the loop condition refreshes."""
        if self._status != BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER:
            raise ValueError("block() can only be entered once")
        self._status = BeamSearchDecoder.IN_BEAM_SEARCH_DECODER
        with self._while_op.block():
            yield
            for slot, value in self._pending:
                layers.assign(value, output=slot)
            layers.increment(x=self._counter, value=1, in_place=True)
            keep_going = layers.less_than(x=self._counter, y=self._max_len_const)
            layers.logical_and(x=keep_going, y=self._cond, out=self._cond)
        self._status = BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER
        self._state_cell._leave_decoder(self)

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    def early_stop(self):
        """Clear the loop condition (a ``break`` that takes effect at the
        end of this step)."""
        self._assert_in_decoder_block("early_stop")
        false = layers.fill_constant(shape=[1], dtype="bool", value=0.0)
        layers.assign(false, output=self._cond)

    def read_array(self, init, is_ids=False, is_scores=False):
        """A loop-carried value seeded with ``init``; pair with
        update_array.  is_ids / is_scores tag the slots whose per-step
        selections feed the final backtrace.  The seed assign is emitted
        in the parent block so the slot is loop-carried, not reset to
        ``init`` on every iteration."""
        self._assert_in_decoder_block("read_array")
        if is_ids and is_scores:
            raise ValueError("a slot cannot be both ids and scores")
        if not isinstance(init, Variable):
            raise TypeError("init must be a Variable, got %r" % type(init))
        with self._in_parent_block():
            slot = layers.assign(init)
        self._slots[slot.name] = slot
        if is_ids:
            self._tagged_arrays[slot.name] = self._ids_array
        elif is_scores:
            self._tagged_arrays[slot.name] = self._scores_array
        return slot

    def update_array(self, array, value):
        """Schedule ``value`` to become ``array``'s content next step.  For
        a slot tagged is_ids/is_scores, the value is also recorded in the
        per-step array that feeds the final backtrace."""
        self._assert_in_decoder_block("update_array")
        slot = self._slots.get(array.name)
        if slot is None:
            raise ValueError("update_array target was not made by read_array")
        if not isinstance(value, Variable):
            raise TypeError("value must be a Variable, got %r" % type(value))
        tagged = self._tagged_arrays.get(array.name)
        if tagged is not None:
            layers.array_write(value, i=self._counter, array=tagged)
        self._pending.append((slot, value))

    def decode(self):
        """The default decode step (reference beam_search_decoder.py:653),
        in static-beam form:

        embed previous ids -> StateCell transition -> project out_state to
        vocab logits -> per-beam topk -> accumulate log-probs ->
        ``layers.beam_search`` -> record (ids, scores, parents) for the
        backtrace -> gather states to follow their parent beam -> stop
        early once every live beam emitted end_id.
        """
        beam = self._beam_size
        with self.block():
            prev_ids = self.read_array(init=self._init_ids, is_ids=True)       # [B, beam]
            prev_scores = self.read_array(init=self._init_scores, is_scores=True)

            flat_prev = layers.reshape(prev_ids, shape=[-1, 1])                # [B*beam, 1]
            prev_emb = layers.embedding(
                flat_prev, size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=self._sparse_emb)
            prev_emb = layers.reshape(prev_emb, shape=[-1, self._word_dim])    # [B*beam, D]

            feed_dict = {}
            update_dict = {}
            for var_name, var in self._input_var_dict.items():
                if var_name not in self._state_cell._inputs:
                    raise ValueError("input_var_dict key %r is not a StateCell"
                                     " input" % var_name)
                # beam-expand the context to [batch*beam, ...] rows, like a
                # state (static analog of the reference's sequence_expand),
                # then carry it so the parent gather below keeps its rows
                # aligned with the state rows each step
                with self._in_parent_block():
                    if beam > 1:
                        tiled = layers.expand(
                            layers.unsqueeze(var, axes=[1]),
                            expand_times=[1, beam] + [1] * (len(var.shape) - 1))
                        var = layers.reshape(
                            tiled, shape=[-1] + list(var.shape[1:]))
                carried = self.read_array(init=var)
                update_dict[var_name] = carried
                feed_dict[var_name] = carried
            for input_name in self._state_cell._inputs:
                if input_name not in feed_dict:
                    feed_dict[input_name] = prev_emb

            self._state_cell.compute_state(inputs=feed_dict)
            cur_state = self._state_cell.out_state()                           # [B*beam, H]
            scores = layers.fc(cur_state, size=self._target_dict_dim, act="softmax")

            k = max(beam, self._topk_size)  # __init__ clamped to vocab
            topk_scores, topk_ids = layers.topk(scores, k=k)
            topk_scores = layers.reshape(topk_scores, shape=[-1, beam, k])
            topk_ids = layers.reshape(topk_ids, shape=[-1, beam, k])
            acc_scores = layers.elementwise_add(
                x=layers.log(topk_scores),
                y=layers.unsqueeze(prev_scores, axes=[2]))
            sel_ids, sel_scores, parents = layers.beam_search(
                prev_ids, prev_scores, topk_ids, acc_scores, beam,
                end_id=self._end_id)

            # the is_ids/is_scores-tagged update_array calls below record
            # sel_ids/sel_scores into the backtrace arrays; parents are the
            # decoder's own bookkeeping
            layers.array_write(parents, i=self._counter, array=self._parents_array)

            # follow the winning lineage: state and carried-context rows
            # move to their parent's row
            flat_parents = self._flat_parent_index(parents, prev_scores)
            for state_name in self._state_cell._state_names:
                reordered = layers.gather(
                    self._state_cell.get_state(state_name), flat_parents)
                self._state_cell.set_state(state_name, reordered)
            self._state_cell.update_states()

            self.update_array(prev_ids, sel_ids)
            self.update_array(prev_scores, sel_scores)
            for _, carried in update_dict.items():
                self.update_array(carried, layers.gather(carried, flat_parents))

            # all beams finished -> break
            alive = layers.reduce_max(layers.cast(
                layers.not_equal(sel_ids,
                                 layers.fill_constant(shape=[1], dtype="int64",
                                                      value=self._end_id)),
                "float32"))
            layers.logical_and(
                x=self._cond,
                y=layers.cast(layers.reshape(alive, shape=[1]), "bool"),
                out=self._cond)

    def _flat_parent_index(self, parents, batch_ref):
        """[batch, beam] parent lanes -> flat row indices into batch*beam."""
        beam = self._beam_size
        ones = layers.fill_constant_batch_size_like(
            input=batch_ref, shape=[-1, 1], dtype="float32", value=1.0)
        row = layers.cumsum(ones, axis=0)                                      # 1..B
        base = layers.scale(row, scale=float(beam), bias=-float(beam))         # (row-1)*beam
        flat = layers.cast(
            layers.elementwise_add(layers.cast(parents, "float32"), base, axis=0),
            "int64")
        return layers.reshape(flat, shape=[-1])

    def __call__(self):
        if self._status != BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER:
            raise ValueError("results are only available after decode()")
        return layers.beam_search_decode(
            self._ids_array, self._scores_array, self._parents_array,
            beam_size=self._beam_size, end_id=self._end_id)

    def _assert_in_decoder_block(self, method):
        if self._status != BeamSearchDecoder.IN_BEAM_SEARCH_DECODER:
            raise ValueError("%s() must be called inside decode()/block()" % method)
