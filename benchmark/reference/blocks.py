"""The one-process env block the copied env code asks for: the reference
always holds every env, so it makes no collective."""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EnvBlock:
    rank: int
    world_size: int
    offset: int
    n_local: int
    n_global: int

    def rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x.narrow(dim, self.offset, self.n_local)


def env_block(n_global: int, rank: int = 0, world_size: int = 1) -> EnvBlock:
    if world_size != 1:
        raise ValueError("the reference holds every env in one process")
    return EnvBlock(rank=0, world_size=1, offset=0, n_local=n_global,
                    n_global=n_global)


def all_reduce_sum(buf: torch.Tensor) -> torch.Tensor:
    return buf
