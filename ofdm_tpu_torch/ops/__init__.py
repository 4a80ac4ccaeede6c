"""Link operators of the PyTorch port: host setup builders and the kernels."""
