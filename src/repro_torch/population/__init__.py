"""Open-world client population: streaming metadata store + arrival index.

See docs/POPULATION.md for the design: hash-derived client attributes
(never materialized), diurnal availability traces per region, scenario
storms (surges / outages), and the online-pool cohort sampler with its
deadline-SLO metrics.
"""

from .arrival import ArrivalIndex, Intervention
from .sampler import OnlinePoolSampler
from .store import ClientMetadataStore, PopulationDataset, splitmix64

__all__ = ["ArrivalIndex", "ClientMetadataStore", "Intervention",
           "OnlinePoolSampler", "PopulationDataset", "splitmix64"]
