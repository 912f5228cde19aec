"""Runtime helpers of the port (the subset of ``lakesoul_tpu/runtime/``
that its stores need)."""
