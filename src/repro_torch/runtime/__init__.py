"""Runtime pieces of the batched driver."""
