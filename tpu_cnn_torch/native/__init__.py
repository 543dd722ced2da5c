"""The native C++ oracle: the port's copy of ``tpu_cnn.native``'s."""
