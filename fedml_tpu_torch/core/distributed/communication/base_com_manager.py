"""Backend protocol: a copy of
``fedml_tpu/core/distributed/communication/base_com_manager.py`` (reference
communication/base_com_manager.py:7)."""

from __future__ import annotations

import abc

from .message import Message


class BaseCommunicationManager(abc.ABC):
    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    @abc.abstractmethod
    def add_observer(self, observer: "Observer") -> None:
        ...

    @abc.abstractmethod
    def remove_observer(self, observer: "Observer") -> None:
        ...

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Blocking receive loop; returns when stopped/finished."""

    @abc.abstractmethod
    def stop_receive_message(self) -> None:
        ...


class Observer(abc.ABC):
    """reference: core/distributed/communication/observer.py"""

    @abc.abstractmethod
    def receive_message(self, msg_type, msg_params: Message) -> None:
        ...
