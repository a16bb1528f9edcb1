"""Training (port of ``repro/training``): AdamW and its schedule, the
train step with microbatch accumulation, checkpoints in the reference's
on-disk format."""
