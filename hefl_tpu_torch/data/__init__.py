"""Data pipeline of the port: synthetic datasets and IID partitioning (numpy
copies of the JAX package's modules) and device-side augmentation."""
