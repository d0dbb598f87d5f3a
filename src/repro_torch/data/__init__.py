from repro_torch.data.synthetic import batch_for_shape, make_batch

__all__ = ["batch_for_shape", "make_batch"]
