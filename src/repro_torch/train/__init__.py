"""Training: AdamW and the microbatched, rematerialised train step."""
