"""Model of the port: the Mamba block and the language model."""
