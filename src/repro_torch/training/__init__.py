from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_opt_state  # noqa: F401
