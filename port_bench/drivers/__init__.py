"""Model drivers: ``drivers/<model>.py`` has ``Program(config, graph,
inputs, device)``, the port's side of a cell (preparation, model,
optimizer, the epoch the window dispatches, and the readings the check
compares)."""
