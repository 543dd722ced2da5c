"""Host-side (numpy) detect head: the port's copies of ``tpu_cnn.head``."""
