"""Training runtime: engine, LR schedules, loss scaling, dataloader."""
