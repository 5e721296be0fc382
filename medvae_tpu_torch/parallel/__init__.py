"""Multi-device training over torch.distributed (counterpart of
medvae_tpu/parallel/): the data-parallel and GAN steps (shard_map_step.py),
tensor parallelism (tensor_parallel.py), the collectives they share
(collectives.py) and the two-node dry run (dcn_dryrun.py). Names resolve
lazily: nn/discriminator.py imports collectives.py, which the steps' own
imports reach."""

_EXPORTS = {
    "build_shard_map_train_step": "shard_map_step",
    "build_shard_map_gan_step": "shard_map_step",
    "build_dp_train_step": "shard_map_step",
    "build_dp_gan_step": "shard_map_step",
    "shard_model": "tensor_parallel",
    "state_shardings": "tensor_parallel",
    "param_sharding_rule": "tensor_parallel",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(name)
