"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
versions. Importing this package builds nothing; ``build.load`` compiles a
kernel the first time a CUDA tensor reaches it."""
