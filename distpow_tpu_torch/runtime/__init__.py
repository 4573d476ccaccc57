"""Runtime support of the port: the metrics registry, the span ring, the
flight recorder and the device-hang watchdog (own copies of the
reference's ``runtime/`` modules of the same names)."""
