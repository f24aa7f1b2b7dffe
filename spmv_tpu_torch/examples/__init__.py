"""Examples of the port, runnable as modules
(`python -m spmv_tpu_torch.examples.<name>`). They import no JAX."""
