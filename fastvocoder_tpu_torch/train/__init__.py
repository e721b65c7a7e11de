"""The GAN train steps and the training state's checkpoints."""
