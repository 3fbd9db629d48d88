"""The zone model on one device and its XOR collectives."""
