"""Entry points of the port: the stream service's load generator
(``python -m repro_torch.launch.stream_serve``)."""
