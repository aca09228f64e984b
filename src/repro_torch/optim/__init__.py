"""AdamW and gradient compression (the port of ``repro.optim``)."""
