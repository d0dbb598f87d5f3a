from repro_torch.train.step import init_ef_state
