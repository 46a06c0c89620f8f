"""Launch helpers of the port (this slice: the error file)."""
