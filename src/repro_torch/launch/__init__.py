"""Entry points of the port (`launch.train`)."""
