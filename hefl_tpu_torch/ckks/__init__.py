"""RNS-CKKS in PyTorch: modular arithmetic, NTT (CUDA kernels + plain
versions), keys (public, relin, Galois), encoding (coefficient and slot),
packing, Galois automorphisms and the cipher ops of the FedAvg round and of
encrypted-inference serving."""
