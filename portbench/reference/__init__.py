"""The benchmark's plain reference: both backbones, the crop,
augmentation and normalization, the AWR encode and decode, the loss and
Adam, in plain PyTorch and numpy.  It imports nothing of the program."""
