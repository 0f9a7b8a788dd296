"""Federated learning of the port: local training with Keras-callback
semantics, the encrypted FedAvg round on one device, and evaluation."""
