from repro_torch.training.train_loop import (  # noqa: F401
    abstract_train_state, init_train_state, make_per_example_step_fns,
    make_train_step, train_state_pspecs)
from repro_torch.data.pipeline import TokenDataset, DataIterator  # noqa: F401
