"""LM training (schedule, AdamW with int8 moments, train step with
microbatches and remat, checkpoint, loop) and the serving steps."""
