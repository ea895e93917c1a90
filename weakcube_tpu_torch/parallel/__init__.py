"""Training steps of the PyTorch package."""
