"""Training side of the port: chapter 01's single-device loop (``cli``),
its ``Trainer`` (``step``), the optimizers (AdamW, adafactor, lion), the
state and its checkpoint form, guards and precision policies, plus the
block-wise int8 helpers the quantized KV pool uses."""
