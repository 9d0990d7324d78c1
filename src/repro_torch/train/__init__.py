"""Training: AdamW with fp32 master weights (``optimizer``) and the
train-step factory (``trainer``)."""
