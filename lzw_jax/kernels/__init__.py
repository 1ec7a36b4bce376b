"""Device kernels of the block container.

* ``encode_triton`` / ``decode_triton``: Pallas kernels for the GPU, through
  Triton, that run a whole batch of independent blocks in one launch, one
  block per thread, with the dictionary loop inside the kernel.
* ``schedule``: static emission schedules of strict variable-width streams
  (numpy and jnp, no kernel).
"""
