"""Sim: builds agent + policy + savers from config, runs trajectories.

Reference: gcp/planning/infra/sim/simulator.py:15-131. A copy of
planning/infra/sim/simulator.py of the JAX package; `device` (the card
unless the run asks for the CPU) reaches the policy through the agent's
parameters, as `log_dir` does.
"""
from __future__ import annotations

from video_gcp_torch.core.params import ParamDict
from video_gcp_torch.planning.infra.agent.savers import HDF5Saver, RawSaver


class Sim:
    def __init__(self, config, gpu_id=0, ngpu=1):
        config = dict(config)
        self._start_goal_list = config.pop("start_goal_list", None)
        self._hp = self._default_hparams()
        for name, value in config.items():
            self._hp[name] = value
        self._hp.agent["log_dir"] = self._hp.log_dir
        self._hp.agent["device"] = self._hp.device  # where a planner runs
        env_params = self._hp.agent["env"][1]
        self._hp.n_rooms = env_params.get("n_rooms", None)
        self.agent = self._hp.agent["type"](self._hp.agent,
                                            self._start_goal_list)
        self.agentparams = self._hp.agent

        logger = self._hp.policy.get("logger", None)
        if self._hp.logging_conf is None and logger is not None:
            self._hp.logging_conf = dict(logger=logger, global_step=-1,
                                         phase="test")

        self.policy = self._hp.policy["type"](
            dict(self.agent._hp), self._hp.policy, gpu_id, ngpu,
            **self.agent.env.env_policy_params(),
        )

        self.savers = []
        if self._hp.save_data:
            if "hdf5" in self._hp.save_format:
                self.savers.append(HDF5Saver(
                    self._hp.data_save_dir, dict(self.agent.env._hp),
                    dict(self.agent._hp),
                    traj_per_file=self._hp.traj_per_file,
                    offset=self._hp.start_index,
                    split_train_val_test=self._hp.split_train_val_test,
                ))
            if "raw" in self._hp.save_format:
                self.savers.append(RawSaver(self._hp.data_save_dir))
        self.logging_conf = self._hp.logging_conf

    def _default_hparams(self):
        return ParamDict(
            save_format=["hdf5", "raw"],
            save_data=True,
            agent={},
            policy={},
            start_index=-1,
            end_index=-1,
            ntraj=-1,
            gpu_id=-1,
            device="cuda",
            current_dir="",
            traj_per_file=10,
            data_save_dir="",
            log_dir="",
            result_dir="",
            split_train_val_test=True,
            logging_conf=None,
        )

    def run(self):
        for i in range(self._hp.start_index, self._hp.end_index + 1):
            self.take_sample(i)
        self.flush()

    def take_sample(self, index):
        self.policy.reset()
        agent_data, obs_dict, policy_out = self.agent.sample(self.policy, index)
        if self._hp.save_data and obs_dict is not None:
            self.save_data(index, agent_data, obs_dict, policy_out)
        if self.logging_conf is not None and agent_data is not None \
                and "goal_image" in agent_data:
            self.policy.log_outputs_stateful(
                **self.logging_conf, dump_dir=self._hp.log_dir, index=index,
            )
        return agent_data

    def save_data(self, itr, agent_data, obs_dict, policy_outputs):
        for saver in self.savers:
            saver.save_traj(itr, agent_data, obs_dict, policy_outputs)

    def flush(self):
        for saver in self.savers:
            if hasattr(saver, "flush"):
                saver.flush()
