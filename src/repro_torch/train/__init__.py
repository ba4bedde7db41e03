"""The training step (``train_step``) and the serving programs of the
static-batch path (``serve_step``)."""
