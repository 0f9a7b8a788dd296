"""RNS-CKKS in PyTorch: modular arithmetic, NTT (CUDA kernels + plain
versions), keys (public, relin, Galois), encoding (coefficient and slot),
packing (float and quantized, with the exact packed-integer codec), Galois
automorphisms and the cipher ops of the FedAvg round and of
encrypted-inference serving."""
