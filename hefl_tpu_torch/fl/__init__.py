"""Federated learning of the port: local training with Keras-callback
semantics, the encrypted FedAvg round on one device (robust and private:
`faults`, `dp`), and evaluation."""
