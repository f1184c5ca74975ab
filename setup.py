"""Packaging (ament-free counterpart of the reference `setup.py`)."""

from setuptools import find_packages, setup

setup(
    name="boundplanner_tpu",
    version="0.1.0",
    description=(
        "TPU-native convex-set path planning + error-bounded MPC engine "
        "(JAX/XLA/Pallas) for 7-DoF arms"
    ),
    packages=find_packages(include=[
        "boundplanner_tpu", "boundplanner_tpu.*",
        "boundplanner_tpu_torch", "boundplanner_tpu_torch.*",
    ]),
    # the PyTorch/CUDA port builds its kernels from these sources at first use
    package_data={"boundplanner_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "scipy",
    ],
    extras_require={
        "viz": ["matplotlib"],
        "test": ["pytest", "chex"],
    },
    include_package_data=True,
)
