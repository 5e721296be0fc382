from medvae_tpu_torch.serve.engine import DEFAULT_BUCKETS, InferenceEngine, MicroBatcher, to_uint8
from medvae_tpu_torch.serve.export import export_model, load_exported

__all__ = ["DEFAULT_BUCKETS", "InferenceEngine", "MicroBatcher", "to_uint8", "export_model",
           "load_exported"]
