"""Plain PyTorch references of the benchmark's configurations, in
float32 with TF32 off. They import nothing of the port: the weights
come from ``portbench/weights.py`` (the same seed draws the same
tensors), and they recompute everything from the inputs."""
