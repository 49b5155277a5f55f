"""Host helpers of the port. Importing this package pulls in no jax."""
