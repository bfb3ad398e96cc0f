"""Packaging (reference: setup.py console script + version gen,
setup.py:10-47)."""

from setuptools import find_packages, setup

setup(
    name="torchacc_tpu",
    version="0.1.0",
    description="TPU-native training-acceleration framework "
                "(JAX/XLA/Pallas)",
    packages=find_packages(include=["torchacc_tpu", "torchacc_tpu.*",
                                    "torchacc_tpu_torch",
                                    "torchacc_tpu_torch.*"]),
    package_data={"torchacc_tpu.data": ["_native/*.cc"],
                  # the PyTorch/CUDA port's kernels, built with nvcc at
                  # first use
                  "torchacc_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy",
    ],
    entry_points={
        "console_scripts": [
            # reference: consolidate_and_reshard_fsdp_ckpts (setup.py:36-40)
            "consolidate_and_reshard_ckpts="
            "torchacc_tpu.checkpoint.cli:main",
        ],
    },
)
