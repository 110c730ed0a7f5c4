"""OT solvers: costs, Sinkhorn (kernel K2), entropic GW (kernel K1), FOT."""
