"""What every cell shares: the card check, statistics, trace reading,
rooflines, the dataset writer, seeded weights, arrivals, spans and the
harness that finds the rest by name."""
