from repro_torch.data.pipeline import make_batch, synthetic_batches

__all__ = ["make_batch", "synthetic_batches"]
