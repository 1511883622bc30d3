"""Steps, optimizers, the Trainer, its checkpoints and stall watchdog, and
the train, evaluate and supervise CLIs."""
