"""The TPU labs on the card: the Hopper counterparts of the TPU lab scripts
that take the traversal kernels apart. scripts/kernel_lab2.py to
kernel_lab5.py take K2's Möller-Trumbore tile walk apart (csrc/
brick_lab.cu; brick.py holds their shared walk), kernel_lab8.py to
kernel_lab11.py take K1 apart (csrc/k1_lab.cu); lab_kernel binds both.
Each module holds its kernel's wrapper, the plain torch version beside it,
and an entry point that prints the lines its script prints:

    python -m tauray_torch.lab.kernel_lab2    # staged bricks (L4)
    python -m tauray_torch.lab.kernel_lab3    # the table read in place (L5)
    python -m tauray_torch.lab.kernel_lab4    # the per-step machinery (L6)
    python -m tauray_torch.lab.kernel_lab5    # Baldwin-Weber against MT (L7)
    python -m tauray_torch.lab.kernel_lab8    # a tile's fixed cost
    python -m tauray_torch.lab.kernel_lab9    # one step bisected
    python -m tauray_torch.lab.kernel_lab10   # K1's walk stripped
    python -m tauray_torch.lab.kernel_lab11   # the test as matrix products

They run on the CUDA card, and raise without one unless --device=cpu asks
for the plain versions."""
