"""Frame I/O of the port: PCD files, padded frame buffers, artifacts."""
