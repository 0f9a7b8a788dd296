"""RNS-CKKS in PyTorch: modular arithmetic, NTT (CUDA kernels + plain
versions), keys, encoding, packing and the cipher ops of the FedAvg round."""
