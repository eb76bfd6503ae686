"""Training (counterpart of ``repro.train``): AdamW with clipping, a
warmup-cosine schedule and int8 error-feedback compression, the train step
with microbatch accumulation and its host loop, atomic keep-K checkpoints
in the JAX package's layout, and restartable training."""
