"""The train step, its state and optimizer, and the Trainer. Names resolve
lazily: losses/gan.py imports train/optim.py, and the train step imports
the losses, so an eager import here would close a cycle."""

_EXPORTS = {
    "build_optimizer": "optim",
    "build_schedule": "optim",
    "TrainState": "state",
    "create_train_state": "state",
    "build_train_step": "step",
    "build_eval_step": "step",
    "Trainer": "trainer",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(name)
