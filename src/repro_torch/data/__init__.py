from repro_torch.data.synthetic import (batch_for_shape, decode_inputs,
                                        input_specs, make_batch)

__all__ = ["batch_for_shape", "decode_inputs", "input_specs", "make_batch"]
