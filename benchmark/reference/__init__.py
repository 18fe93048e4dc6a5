"""The plain reference of GPPVAE-joint: plain PyTorch, no kernels, imports
nothing of the program."""
