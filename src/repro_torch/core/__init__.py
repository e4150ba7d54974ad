"""NIMBLE core, ported: topology, candidate paths, cost model, incidence
tables, slot schedule, the MWU planner, the stacked-rank dataplane, and MoE
dispatch/combine."""
