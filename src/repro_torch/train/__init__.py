from repro_torch.train.step import (TrainHParams, init_ef_state,
                                    make_compressed_train_step,
                                    make_decode_step, make_prefill_step,
                                    make_train_step, rank_ef_state)

__all__ = ["TrainHParams", "init_ef_state", "make_compressed_train_step",
           "make_decode_step", "make_prefill_step", "make_train_step",
           "rank_ef_state"]
