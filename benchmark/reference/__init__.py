"""Plain float32 PyTorch references of the benchmark's models and of a
FedAvg round.  Nothing here imports the program under test."""
