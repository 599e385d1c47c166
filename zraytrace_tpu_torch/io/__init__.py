"""Image input/output: PNG (``png``) and plain PPM (``ppm``)."""
