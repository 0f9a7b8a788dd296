"""Federated learning of the port: local training with Keras-callback
semantics, the encrypted FedAvg round on one device (robust and private:
`faults`, `dp`), the streaming aggregation service (`stream`, `journal`,
`server`; flat or through the host tiers of `hierarchy`), and evaluation."""
