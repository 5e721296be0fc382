from medvae_tpu_torch.serve.engine import InferenceEngine, MicroBatcher, to_uint8

__all__ = ["InferenceEngine", "MicroBatcher", "to_uint8"]
