"""Training-side pieces of the port: AdamW with int8 moments and int8
error-feedback gradient compression (:mod:`.optimizer`), the LM train-step
factory (:mod:`.trainer`), checkpoints in the JAX package's layout
(:mod:`.checkpoint`) and the fault-tolerant supervisor (:mod:`.ft`). The
detector's train step is ``repro_torch.eval.harness.train_step``."""
