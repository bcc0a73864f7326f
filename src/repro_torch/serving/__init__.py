"""Host-side fleet construction of the port: tier profiles, the replayed
arrival queue and heterogeneous fleets."""
