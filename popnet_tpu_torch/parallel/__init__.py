"""Parallel training and inference over `torch.distributed` (the JAX
package's `popnet_tpu/parallel/`): process groups and the launcher
(`distributed`), the rank mesh and data parallelism (`mesh`), channel
sharding (`tensor`), height bands (`spatial`) and the GPipe pipeline
(`pipeline`); `checks` holds the jobs that hold each layout against one
device."""
