from repro_torch.training.train_loop import (  # noqa: F401
    abstract_train_state, init_train_state, make_train_step)
