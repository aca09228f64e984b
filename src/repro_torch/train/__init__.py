"""Train / serve step factories (the port of ``repro.train``)."""
from . import steps
from .steps import (TrainState, init_train_state, make_decode_step,
                    make_eval_step, make_prefill_step, make_train_step,
                    train_state_specs)
