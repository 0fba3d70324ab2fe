"""The port's counterparts of the JAX package's `examples/` measurement
scripts, one module per script with the script's file name:

    python -m radnerf_tpu_torch.examples.<name> [the script's flags]
        [--device cuda|cpu]

Each module does its work in `run(...)` (sizes and configs as arguments)
and `main(argv=None)`; importing one does nothing. The first line of a
run is the card's name, or `cpu` when the caller asked for the CPU (a CPU
run measures PyTorch's CPU kernels, not the card).
"""
