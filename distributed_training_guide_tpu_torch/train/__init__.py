"""Training-side helpers of the port (this slice: block-wise int8)."""
