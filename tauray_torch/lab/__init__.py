"""The K1 labs on the card: the Hopper counterparts of the TPU lab scripts
that take K1 (tauray_tpu's _kernel_vm3) apart, scripts/kernel_lab8.py to
kernel_lab11.py. Each module holds its kernel's wrapper (csrc/k1_lab.cu,
bound in lab_kernel), the plain torch version beside it, and an entry
point that prints the lines its script prints:

    python -m tauray_torch.lab.kernel_lab8    # a tile's fixed cost
    python -m tauray_torch.lab.kernel_lab9    # one step bisected
    python -m tauray_torch.lab.kernel_lab10   # K1's walk stripped
    python -m tauray_torch.lab.kernel_lab11   # the test as matrix products

They run on the CUDA card, and raise without one unless --device=cpu asks
for the plain versions."""
