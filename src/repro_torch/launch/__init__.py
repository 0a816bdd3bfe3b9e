"""Command-line drivers of the port (serve, train, the dry run) and the
roofline model the dry run reports with."""
