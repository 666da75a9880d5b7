"""The plain reference the benchmark holds the port to (model, warp,
losses, optimizer steps) and its one-precision-down control."""
